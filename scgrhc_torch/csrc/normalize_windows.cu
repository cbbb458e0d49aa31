// K4: per-window joint min-max normalization.
//
// Replaces the TPU kernel scgrhc/ops/pallas/dsp.py::normalize_windows
// (_norm_kernel): out = (w - lo) / (hi - lo + 1e-4), with lo and hi the
// min and max over each window's C*T values (NORM_EPS, reference
// recordutil.py:41-47).
//
// What bounds it: bytes.  It reads each window once and writes it once
// (24 KB for a 4 x 750 f32 window) and does three operations per element.
// Design: one block per window.  The block first reduces lo and hi over
// the window (the second pass then finds it in L1/L2), then writes the
// normalized values; the division is IEEE-exact (no fast math), so the
// result equals the plain version's bit for bit.
//
// NaN: sentinel ADC samples become NaN, and the reference min/max
// propagate NaN, so a window holding one normalizes to all NaN.  fminf and
// fmaxf drop NaN; the kernel therefore tracks it separately and sets lo
// and hi to NaN when any value is NaN.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNormEps = 1e-4f;

__global__ void __launch_bounds__(kThreads)
normalize_windows_kernel(const float* __restrict__ w, float* __restrict__ out, int m) {
  __shared__ float s_lo[kWarps], s_hi[kWarps];
  __shared__ int s_nan[kWarps];
  __shared__ float s_stat[2];

  const int tid = threadIdx.x;
  const float* src = w + (size_t)blockIdx.x * m;
  float* dst = out + (size_t)blockIdx.x * m;

  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  int nan = 0;
  for (int i = tid; i < m; i += kThreads) {
    const float v = src[i];
    if (v != v) {
      nan = 1;
    } else {
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    nan |= __shfl_xor_sync(0xffffffffu, nan, off);
  }
  if ((tid & 31) == 0) {
    s_lo[tid >> 5] = lo;
    s_hi[tid >> 5] = hi;
    s_nan[tid >> 5] = nan;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < kWarps; ++i) {
      lo = fminf(lo, s_lo[i]);
      hi = fmaxf(hi, s_hi[i]);
      nan |= s_nan[i];
    }
    s_stat[0] = nan ? CUDART_NAN_F : lo;
    s_stat[1] = nan ? CUDART_NAN_F : hi;
  }
  __syncthreads();
  lo = s_stat[0];
  const float den = s_stat[1] - lo + kNormEps;
  for (int i = tid; i < m; i += kThreads) dst[i] = (src[i] - lo) / den;
}

}  // namespace

// w and out (n, m) float32, contiguous, m = C*T.  Returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int scgrhc_normalize_windows(const void* w, void* out, int n, int m,
                                        void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  normalize_windows_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(out), m);
  return (int)cudaGetLastError();
}

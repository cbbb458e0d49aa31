// K3: the data stage's noise gate and min-max normalization of framed windows.
//
// Replaces the TPU kernel scgrhc/ops/pallas/dsp.py::gate_and_normalize
// (_gate_norm_kernel).  For each window n of scg (N, C, T) and rhc (N, T),
// float32:
//   * keep[n] = !(flat || straight || below), with
//       flat:     the sliding max - min over `win` samples is below 1e-3 at
//                 two or more positions (never for T < win);
//       straight: the closed-form OLS r^2 of rhc against the sample index is
//                 above 0.8, and r^2 = 1 where sxx * syy <= 0 (or is NaN);
//       below:    any rhc sample is below min_rhc;
//   * rhc_out = (rhc - lo) / (hi - lo + 1e-4) with (lo, hi) over the window,
//     scg_out the same with (lo, hi) jointly over its (C, T) values, and
//     mm_rhc[n] / mm_scg[n] = (lo, hi)  (NORM_EPS, reference
//     recordutil.py:41-47).
//
// What bounds it: bytes.  It reads N (C + 1) T floats and writes as many
// (9.0 MB at N = 300, C = 4, T = 750: 2.7 us at 3.35 TB/s); the gate's
// arithmetic is a few dozen operations per rhc sample.  At the data stage's
// sizes (one launch per chamber interval, a few hundred windows) launch
// latency sets its time.
// Design: one block per window, so the grid has N blocks and nothing crosses
// blocks.  The block stages the rhc window in shared memory (3 KB at
// T = 750) while reducing its sum, min, max and the range test, and reduces
// the scg window's min and max; a second pass over shared memory computes
// the centred OLS sums and the flat count (each position scans its `win`
// samples directly: 35 K shared-memory reads a window); a last pass writes
// the normalized values, the scg window coming back from L1/L2.  Sums are
// f32, as in the JAX kernel, so an r^2 within rounding of 0.8 may decide
// the other way; min, max and the normalizing division are exact (IEEE
// division, no fast math), so those outputs equal the plain version's.
//
// NaN: jnp.min/jnp.max propagate NaN, CUDA's fminf/fmaxf drop it.  The
// kernel's min/max keep a NaN once seen, so a window holding one has NaN
// (lo, hi) and all-NaN normalized values, a NaN sliding range (never flat),
// and a NaN r^2 denominator (straight, so keep = false), as in JAX.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNormEps = 1e-4f;
constexpr float kFlatThreshold = 1e-3f;
constexpr float kR2Threshold = 0.8f;

// min/max that keep a NaN once either side holds one
__device__ __forceinline__ float nan_min(float a, float v) { return (v < a || v != v) ? v : a; }
__device__ __forceinline__ float nan_max(float a, float v) { return (v > a || v != v) ? v : a; }

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  __device__ float operator()(float a, float b) const { return nan_min(a, b); }
};
struct Max {
  __device__ float operator()(float a, float b) const { return nan_max(a, b); }
};

// Every thread gets the block's reduction of v, in a fixed order (a warp
// butterfly, then the warps in turn), so repeated launches give the same bits.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = buf[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, buf[w]);
  __syncthreads();  // buf is reused by the next reduction
  return r;
}

__global__ void __launch_bounds__(kThreads)
gate_normalize_kernel(const float* __restrict__ scg, const float* __restrict__ rhc,
                      float* __restrict__ scg_out, float* __restrict__ rhc_out,
                      unsigned char* __restrict__ keep, float* __restrict__ mm_scg,
                      float* __restrict__ mm_rhc, int m, int t, int win, float min_rhc) {
  extern __shared__ float s_rhc[];  // the window's t rhc samples
  __shared__ float f_buf[kWarps];
  __shared__ int i_buf[kWarps];

  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const float* r = rhc + n * t;
  const float* s = scg + n * m;

  // pass 1: stage rhc; its sum, min, max and range test; the scg min and max
  float sum = 0.f, lo = CUDART_INF_F, hi = -CUDART_INF_F;
  int below = 0;
  for (int i = tid; i < t; i += kThreads) {
    const float v = r[i];
    s_rhc[i] = v;
    sum += v;
    lo = nan_min(lo, v);
    hi = nan_max(hi, v);
    below |= v < min_rhc;
  }
  float s_lo = CUDART_INF_F, s_hi = -CUDART_INF_F;
  for (int i = tid; i < m; i += kThreads) {
    const float v = s[i];
    s_lo = nan_min(s_lo, v);
    s_hi = nan_max(s_hi, v);
  }
  sum = block_reduce(sum, Sum(), f_buf);  // its syncs also publish s_rhc
  lo = block_reduce(lo, Min(), f_buf);
  hi = block_reduce(hi, Max(), f_buf);
  s_lo = block_reduce(s_lo, Min(), f_buf);
  s_hi = block_reduce(s_hi, Max(), f_buf);
  below = block_reduce(below, Sum(), i_buf);

  // pass 2: the centred OLS sums against the sample index, and the flat count
  const float mean = sum / (float)t;
  const float x_mid = (float)(t - 1) * 0.5f;
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
  for (int i = tid; i < t; i += kThreads) {
    const float xc = (float)i - x_mid;
    const float yc = s_rhc[i] - mean;
    sxx += xc * xc;
    sxy += yc * xc;
    syy += yc * yc;
  }
  int flat = 0;
  for (int p = tid; p + win <= t; p += kThreads) {
    float w_lo = CUDART_INF_F, w_hi = -CUDART_INF_F;
    for (int k = 0; k < win; ++k) {
      const float v = s_rhc[p + k];
      w_lo = nan_min(w_lo, v);
      w_hi = nan_max(w_hi, v);
    }
    flat += (w_hi - w_lo) < kFlatThreshold;  // false for a NaN range
  }
  sxx = block_reduce(sxx, Sum(), f_buf);
  sxy = block_reduce(sxy, Sum(), f_buf);
  syy = block_reduce(syy, Sum(), f_buf);
  flat = block_reduce(flat, Sum(), i_buf);

  if (tid == 0) {
    const float denom = sxx * syy;
    const float r2 = denom > 0.f ? (sxy * sxy) / denom : 1.f;  // NaN denom: 1
    keep[n] = !(flat >= 2 || r2 > kR2Threshold || below > 0);
    mm_rhc[2 * n] = lo;
    mm_rhc[2 * n + 1] = hi;
    mm_scg[2 * n] = s_lo;
    mm_scg[2 * n + 1] = s_hi;
  }

  // pass 3: the normalizing writes
  const float den = hi - lo + kNormEps;
  float* ro = rhc_out + n * t;
  for (int i = tid; i < t; i += kThreads) ro[i] = (s_rhc[i] - lo) / den;
  const float s_den = s_hi - s_lo + kNormEps;
  float* so = scg_out + n * m;
  for (int i = tid; i < m; i += kThreads) so[i] = (s[i] - s_lo) / s_den;
}

}  // namespace

// scg (n, c, t) and rhc (n, t) float32, contiguous; scg_out and rhc_out the
// same shapes; keep (n,) bytes; mm_scg and mm_rhc (n, 2) float32.  t * 4
// bytes of shared memory must fit the default 48 KB.  Returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int scgrhc_gate_normalize(const void* scg, const void* rhc, void* scg_out,
                                     void* rhc_out, void* keep, void* mm_scg, void* mm_rhc,
                                     int n, int c, int t, int win, float min_rhc,
                                     void* stream) {
  if (n <= 0 || c <= 0 || t <= 0 || win <= 0 || (size_t)t * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  gate_normalize_kernel<<<n, kThreads, t * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scg), static_cast<const float*>(rhc),
      static_cast<float*>(scg_out), static_cast<float*>(rhc_out),
      static_cast<unsigned char*>(keep), static_cast<float*>(mm_scg),
      static_cast<float*>(mm_rhc), c * t, t, win, min_rhc);
  return (int)cudaGetLastError();
}

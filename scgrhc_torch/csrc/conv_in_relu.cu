// K1f: fused conv1d(k=3, p=1) + bias + InstanceNorm + ReLU, forward only.
//
// Replaces the TPU kernel scgrhc/ops/pallas/conv_block.py::conv_in_relu
// (_fwd_kernel).  For each (sample n, output channel o):
//   c[t] = b[o] + sum_i w[o,i,0]*x[i,t-1] + w[o,i,1]*x[i,t] + w[o,i,2]*x[i,t+1]
//   mean, msq over t in f32; var = max(msq - mean^2, 0)
//   y[t] = max((c[t] - mean) * rsqrt(var + 1e-5), 0), stored in x's dtype.
//
// What bounds it: operations.  A generator layer does 6*C_in*O*T FLOPs per
// sample on (C_in + O)*T elements of traffic (the bottleneck layer: 1.17
// GFLOP against 3 MB per window), far above the H100's f32 ridge point.
// This kernel runs on the f32 FMA units (67 TFLOP/s); tensor cores
// (wgmma, TMA) are later work.
//
// Design: one block per (sample, tile of kOTile output channels).  The
// TPU kernel held a whole (C_in, T) sample in VMEM; a 512 x 750 f32
// sample is 1.5 MB, far over a block's shared memory, so here the block
// keeps only its tile's full-T conv sums, in registers (each of the 256
// threads owns up to kMaxTpt time steps of all kOTile channels), and walks
// C_in in chunks of kCiChunk channels: each chunk of x is staged in shared
// memory with its zero halo, beside the chunk's kOTile x 3 weight taps.
// Every staged x value then feeds kOTile*3 FMAs from registers, and the
// weights are read as float4 broadcasts.  After the last chunk the block
// reduces the instance-norm statistics over T per channel (warp shuffles,
// then across warps in shared memory) and writes y once: one read of x per
// output tile and one write of y, with no intermediate in device memory.
//
// NaN propagates as in the plain version: comparisons written as
// `v < 0 ? 0 : v` keep a NaN where fmaxf would drop it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOTile = 16;
constexpr int kCiChunk = 8;
constexpr int kMaxTpt = 4;  // time steps per thread: T <= kMaxTpt * kThreads
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int TPT>
__global__ void __launch_bounds__(kThreads)
conv_in_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b, T* __restrict__ y, int cin,
                    int cout, int len) {
  // xs[ci][j] holds x[c0 + ci][j - 1]; column 0 and columns past len are
  // the zero halo, so output step t reads xs[ci][t .. t + 2] unguarded.
  constexpr int kStride = TPT * kThreads + 2;
  __shared__ float xs[kCiChunk][kStride];
  __shared__ __align__(16) float ws[kCiChunk][kOTile * 3];  // [ci][o*3 + k]
  __shared__ float red[kWarps][kOTile][2];
  __shared__ float stat[kOTile][2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int o0 = blockIdx.x * kOTile;
  const int n = blockIdx.y;
  const T* xn = x + (size_t)n * cin * len;

  float acc[kOTile][TPT];
#pragma unroll
  for (int o = 0; o < kOTile; ++o)
#pragma unroll
    for (int k = 0; k < TPT; ++k) acc[o][k] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCiChunk) {
    const int cc = min(kCiChunk, cin - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < kCiChunk * kStride; i += kThreads) {
      const int ci = i / kStride;
      const int j = i - ci * kStride;
      float v = 0.f;
      if (ci < cc && j >= 1 && j <= len) v = to_f32(xn[(size_t)(c0 + ci) * len + (j - 1)]);
      xs[ci][j] = v;
    }
    for (int i = tid; i < kCiChunk * kOTile * 3; i += kThreads) {
      const int ci = i / (kOTile * 3);
      const int r = i - ci * (kOTile * 3);
      const int o = r / 3;
      const int k = r - o * 3;
      float v = 0.f;
      if (ci < cc && o0 + o < cout) v = to_f32(w[((size_t)(o0 + o) * cin + c0 + ci) * 3 + k]);
      ws[ci][r] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < cc; ++ci) {
      float xv[TPT][3];
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const int t = tid + k * kThreads;
        xv[k][0] = xs[ci][t];
        xv[k][1] = xs[ci][t + 1];
        xv[k][2] = xs[ci][t + 2];
      }
      const float4* wr = reinterpret_cast<const float4*>(ws[ci]);
#pragma unroll
      for (int og = 0; og < kOTile / 4; ++og) {
        const float4 q0 = wr[og * 3], q1 = wr[og * 3 + 1], q2 = wr[og * 3 + 2];
        const float wv[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                              q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int k = 0; k < TPT; ++k) {
            float a = acc[og * 4 + u][k];
            a = fmaf(wv[u * 3 + 0], xv[k][0], a);
            a = fmaf(wv[u * 3 + 1], xv[k][1], a);
            a = fmaf(wv[u * 3 + 2], xv[k][2], a);
            acc[og * 4 + u][k] = a;
          }
        }
      }
    }
  }

  // bias, then the per-channel sums of c and c^2 over the valid steps
#pragma unroll
  for (int o = 0; o < kOTile; ++o) {
    const float bias = (o0 + o < cout) ? to_f32(b[o0 + o]) : 0.f;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const float c = acc[o][k] + bias;
      acc[o][k] = c;
      if (tid + k * kThreads < len) {
        s += c;
        q += c * c;
      }
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      red[warp][o][0] = s;
      red[warp][o][1] = q;
    }
  }
  __syncthreads();
  if (tid < kOTile) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      s += red[i][tid][0];
      q += red[i][tid][1];
    }
    const float mean = s / (float)len;
    float var = q / (float)len - mean * mean;
    var = var < 0.f ? 0.f : var;
    stat[tid][0] = mean;
    stat[tid][1] = rsqrtf(var + kEps);
  }
  __syncthreads();

#pragma unroll
  for (int o = 0; o < kOTile; ++o) {
    if (o0 + o >= cout) break;
    const float mean = stat[o][0];
    const float rsig = stat[o][1];
    T* yo = y + ((size_t)n * cout + o0 + o) * len;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int t = tid + k * kThreads;
      if (t < len) {
        const float v = (acc[o][k] - mean) * rsig;
        store(yo + t, v < 0.f ? 0.f : v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int n,
                   int cin, int cout, int len, cudaStream_t stream) {
  const dim3 grid((cout + kOTile - 1) / kOTile, n);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  switch ((len + kThreads - 1) / kThreads) {
    case 1: conv_in_relu_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, wp, bp, yp, cin, cout, len); break;
    case 2: conv_in_relu_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xp, wp, bp, yp, cin, cout, len); break;
    case 3: conv_in_relu_kernel<T, 3><<<grid, kThreads, 0, stream>>>(xp, wp, bp, yp, cin, cout, len); break;
    case 4: conv_in_relu_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, wp, bp, yp, cin, cout, len); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x (n, cin, len), w (cout, cin, 3), b (cout,), y (n, cout, len), all
// contiguous and of one dtype: 0 = float32, 1 = bfloat16.  Returns the
// launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int scgrhc_conv_in_relu(const void* x, const void* w, const void* b,
                                   void* y, int n, int cin, int cout, int len,
                                   int dtype, void* stream) {
  if (n <= 0 || n > 65535 || cin <= 0 || cout <= 0 || len <= 0 ||
      len > kMaxTpt * kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, b, y, n, cin, cout, len, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, b, y, n, cin, cout, len, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int scgrhc_conv_in_relu_max_len() { return kMaxTpt * kThreads; }

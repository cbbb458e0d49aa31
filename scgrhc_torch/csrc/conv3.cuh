// Device code shared by the conv1d(k=3, padding=1) layer kernels: the
// generator's conv + InstanceNorm + ReLU layer (conv_in_relu.cu: K1f, K1b)
// and the critic's layer in its three modes (critic_layer.cu: K2f, K2dx,
// K2dw).  Layouts are PyTorch's: x (N, C, T), w (O, C, 3), b (O,).
//
// Modes, for c = conv1d(x, w, padding=1) + b:
//   linear   y = c
//   relu     y = relu(c)
//   in_relu  y = relu((c - mean_T c) * rsqrt(var_T c + 1e-5)), one-pass
//            biased statistics in f32 (var = max(E[c^2] - mean^2, 0))
//
// Three passes make every backward:
//   dc  recompute c (no forward residual is saved), then the mode's
//       backward into an f32 scratch (N, O, T):
//         linear   dc = dy
//         relu     dc = dy * (c > 0)
//         in_relu  g = dy * (xhat > 0),
//                  dc = rsig * (g - mean_T g - xhat * mean_T(g * xhat))
//   dx  dx = conv3_t(w, dc): a conv over dc with the taps flipped and the
//       channel axes of w swapped, no bias, stored in x's dtype
//   dw  dw[o, i, k] = sum_{n,t} dc[n, o, t] * x[n, i, t + k - 1] and
//       db[o] = sum_{n,t} dc[n, o, t], in f32
// As in the Pallas kernels, dx and dw take dc rounded to x's dtype
// (a no-op in f32); db sums the f32 dc.
//
// The forward and dc passes keep a block's kOTile output channels for the
// whole of T in registers (each of kThreads threads owns up to kMaxTpt
// steps), staging C_in through shared memory kCiChunk channels at a time
// with a zero halo, so the statistics over T are block reductions and c
// never touches device memory.  The dx pass is the same conv loop over dc.
// The dw pass is a tiled product over the (sample, step) axis, split over
// samples into per-block partial sums that a second kernel adds in a fixed
// order: no float atomics, so a run gives the same bits every time.
//
// NaN propagates as in the plain versions: a relu is `v < 0 ? 0 : v` and a
// mask is a multiply by (v > 0 ? 1 : 0), never fmaxf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scgrhc {
namespace {  // internal linkage: each including source has its own copy

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOTile = 16;
constexpr int kCiChunk = 8;
constexpr int kMaxTpt = 4;  // time steps per thread: T <= kMaxTpt * kThreads
constexpr float kEps = 1e-5f;

enum Mode { kLinear = 0, kRelu = 1, kInRelu = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v rounded to R's precision, returned in f32
template <typename R> __device__ __forceinline__ float round_to(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }
__device__ __forceinline__ float step(float v) { return v > 0.f ? 1.f : 0.f; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int TPT>
struct ConvSmem {
  // xs[ci][j] holds input channel c0 + ci at step j - 1; column 0 and the
  // columns past len are the zero halo, so output step t reads
  // xs[ci][t .. t + 2] unguarded.
  static constexpr int kStride = TPT * kThreads + 2;
  float xs[kCiChunk][kStride];
  __align__(16) float ws[kCiChunk][kOTile * 3];  // [ci][o * 3 + tap]
};

struct RedSmem {
  float red[kWarps][kOTile][2];
  float tot[kOTile][2];
  float st[kOTile][2];  // per-channel (mean, rsig) of the in_relu norm
};

// acc[o][k] = sum over input channels i and taps of W(o0 + o, i, tap) *
// in[i][t + tap - 1] at t = threadIdx.x + k * kThreads, zero outside
// [0, len).  W(o, i, tap) is w[(o * cin + i) * 3 + tap], or with TRANSW
// (the dx pass: w is the layer's (cin, cout, 3) weight read transposed
// and flipped) w[(i * cout + o) * 3 + 2 - tap].  Staged inputs are
// rounded to R's precision.
template <typename TIN, typename TW, typename R, int TPT, bool TRANSW>
__device__ __forceinline__ void conv_accumulate(const TIN* __restrict__ in,
                                                const TW* __restrict__ w, int cin,
                                                int cout, int len, int o0,
                                                ConvSmem<TPT>& sm,
                                                float (&acc)[kOTile][TPT]) {
  constexpr int kStride = ConvSmem<TPT>::kStride;
  const int tid = threadIdx.x;
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
      if (ci < cc && j >= 1 && j <= len)
        v = round_to<R>(to_f32(in[(size_t)(c0 + ci) * len + (j - 1)]));
      sm.xs[ci][j] = v;
    }
    for (int i = tid; i < kCiChunk * kOTile * 3; i += kThreads) {
      const int ci = i / (kOTile * 3);
      const int r = i - ci * (kOTile * 3);
      const int o = r / 3;
      const int k = r - o * 3;
      float v = 0.f;
      if (ci < cc && o0 + o < cout) {
        v = TRANSW ? to_f32(w[((size_t)(c0 + ci) * cout + o0 + o) * 3 + (2 - k)])
                   : to_f32(w[((size_t)(o0 + o) * cin + c0 + ci) * 3 + k]);
      }
      sm.ws[ci][r] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < cc; ++ci) {
      float xv[TPT][3];
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const int t = tid + k * kThreads;
        xv[k][0] = sm.xs[ci][t];
        xv[k][1] = sm.xs[ci][t + 1];
        xv[k][2] = sm.xs[ci][t + 2];
      }
      const float4* wr = reinterpret_cast<const float4*>(sm.ws[ci]);
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
}

// c = conv1d(x_n, w, padding=1) + b for the block's channels, in acc.
template <typename T, int TPT>
__device__ __forceinline__ void conv_bias(const T* __restrict__ xn, const T* __restrict__ w,
                                          const T* __restrict__ b, int cin, int cout,
                                          int len, int o0, ConvSmem<TPT>& sm,
                                          float (&acc)[kOTile][TPT]) {
  conv_accumulate<T, T, float, TPT, false>(xn, w, cin, cout, len, o0, sm, acc);
#pragma unroll
  for (int o = 0; o < kOTile; ++o) {
    const float bias = (o0 + o < cout) ? to_f32(b[o0 + o]) : 0.f;
#pragma unroll
    for (int k = 0; k < TPT; ++k) acc[o][k] += bias;
  }
}

// Block totals of the per-thread partial sums s[o] and q[o], into r.tot.
__device__ __forceinline__ void block_sum2(const float (&s)[kOTile], const float (&q)[kOTile],
                                           RedSmem& r) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 0; o < kOTile; ++o) {
    const float a = warp_sum(s[o]);
    const float c = warp_sum(q[o]);
    if (lane == 0) {
      r.red[warp][o][0] = a;
      r.red[warp][o][1] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kOTile) {
    const int o = threadIdx.x >> 1;
    const int j = threadIdx.x & 1;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) v += r.red[i][o][j];
    r.tot[o][j] = v;
  }
  __syncthreads();
}

// The in_relu statistics of c (in acc) into r.st: (mean, rsig) per channel.
template <int TPT>
__device__ __forceinline__ void in_stats(const float (&acc)[kOTile][TPT], int len, RedSmem& r) {
  float s[kOTile], q[kOTile];
#pragma unroll
  for (int o = 0; o < kOTile; ++o) {
    s[o] = 0.f;
    q[o] = 0.f;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      if (threadIdx.x + k * kThreads < len) {
        s[o] += acc[o][k];
        q[o] += acc[o][k] * acc[o][k];
      }
    }
  }
  block_sum2(s, q, r);
  if (threadIdx.x < kOTile) {
    const float mean = r.tot[threadIdx.x][0] / (float)len;
    float var = r.tot[threadIdx.x][1] / (float)len - mean * mean;
    var = var < 0.f ? 0.f : var;
    r.st[threadIdx.x][0] = mean;
    r.st[threadIdx.x][1] = rsqrtf(var + kEps);
  }
  __syncthreads();
}

// Forward: one block per (tile of kOTile output channels, sample).
template <typename T, int MODE, int TPT>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
           T* __restrict__ y, int cin, int cout, int len) {
  __shared__ ConvSmem<TPT> sm;
  __shared__ RedSmem rs;
  const int o0 = blockIdx.x * kOTile;
  const int n = blockIdx.y;
  float acc[kOTile][TPT];
  conv_bias<T, TPT>(x + (size_t)n * cin * len, w, b, cin, cout, len, o0, sm, acc);
  if (MODE == kInRelu) in_stats<TPT>(acc, len, rs);
#pragma unroll
  for (int o = 0; o < kOTile; ++o) {
    if (o0 + o >= cout) break;
    T* yo = y + ((size_t)n * cout + o0 + o) * len;
    float mean = 0.f, rsig = 1.f;
    if (MODE == kInRelu) {
      mean = rs.st[o][0];
      rsig = rs.st[o][1];
    }
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int t = threadIdx.x + k * kThreads;
      if (t < len) {
        float v = acc[o][k];
        if (MODE == kInRelu) v = relu((v - mean) * rsig);
        if (MODE == kRelu) v = relu(v);
        store(yo + t, v);
      }
    }
  }
}

// dc pass of the relu and in_relu modes (linear: dc_linear_kernel).
template <typename T, int MODE, int TPT>
__global__ void __launch_bounds__(kThreads)
dc_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
          const T* __restrict__ dy, float* __restrict__ dc, int cin, int cout, int len) {
  __shared__ ConvSmem<TPT> sm;
  __shared__ RedSmem rs;
  const int o0 = blockIdx.x * kOTile;
  const int n = blockIdx.y;
  const size_t base = ((size_t)n * cout + o0) * len;
  float acc[kOTile][TPT];
  conv_bias<T, TPT>(x + (size_t)n * cin * len, w, b, cin, cout, len, o0, sm, acc);
  if (MODE == kRelu) {
#pragma unroll
    for (int o = 0; o < kOTile; ++o) {
      if (o0 + o >= cout) break;
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const int t = threadIdx.x + k * kThreads;
        if (t < len) {
          const size_t i = base + (size_t)o * len + t;
          dc[i] = to_f32(dy[i]) * step(acc[o][k]);
        }
      }
    }
    return;
  }
  in_stats<TPT>(acc, len, rs);
  // acc becomes xhat; then the sums of g and g * xhat over T
  float s[kOTile], q[kOTile];
#pragma unroll
  for (int o = 0; o < kOTile; ++o) {
    const float mean = rs.st[o][0];
    const float rsig = rs.st[o][1];
    s[o] = 0.f;
    q[o] = 0.f;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int t = threadIdx.x + k * kThreads;
      const float xh = (acc[o][k] - mean) * rsig;
      acc[o][k] = xh;
      if (t < len && o0 + o < cout) {
        const float g = to_f32(dy[base + (size_t)o * len + t]) * step(xh);
        s[o] += g;
        q[o] += g * xh;
      }
    }
  }
  block_sum2(s, q, rs);
#pragma unroll
  for (int o = 0; o < kOTile; ++o) {
    if (o0 + o >= cout) break;
    const float rsig = rs.st[o][1];
    const float mg = rs.tot[o][0] / (float)len;
    const float mgx = rs.tot[o][1] / (float)len;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int t = threadIdx.x + k * kThreads;
      if (t < len) {
        const size_t i = base + (size_t)o * len + t;
        const float xh = acc[o][k];
        const float g = to_f32(dy[i]) * step(xh);
        dc[i] = rsig * ((g - mg) - xh * mgx);
      }
    }
  }
}

template <typename T>
__global__ void dc_linear_kernel(const T* __restrict__ dy, float* __restrict__ dc, size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dc[i] = to_f32(dy[i]);
}

// dx pass: one block per (tile of kOTile input channels of the layer, sample).
template <typename T, int TPT>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const float* __restrict__ dc, const T* __restrict__ w, T* __restrict__ dx,
          int cin, int cout, int len) {
  __shared__ ConvSmem<TPT> sm;
  const int i0 = blockIdx.x * kOTile;
  const int n = blockIdx.y;
  float acc[kOTile][TPT];
  // a conv from cout channels (dc) to cin channels (dx)
  conv_accumulate<float, T, T, TPT, true>(dc + (size_t)n * cout * len, w, cout, cin, len,
                                          i0, sm, acc);
#pragma unroll
  for (int i = 0; i < kOTile; ++i) {
    if (i0 + i >= cin) break;
    T* dxi = dx + ((size_t)n * cin + i0 + i) * len;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int t = threadIdx.x + k * kThreads;
      if (t < len) store(dxi + t, acc[i][k]);
    }
  }
}

// dw pass, stage 1: part[z][o][j] over the samples of split z, with
// j = i * 3 + tap over the 3 * cin columns (dw's (O, C, 3) layout).
constexpr int kBM = 64, kBN = 64, kBK = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ dc, const T* __restrict__ x,
                  float* __restrict__ part, int n, int cin, int cout, int len, int nsplit) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * kBM;
  const int j0 = blockIdx.y * kBN;
  const int z = blockIdx.z;
  const int ncols = 3 * cin;
  const int s_begin = (int)(((long long)n * z) / nsplit);
  const int s_end = (int)(((long long)n * (z + 1)) / nsplit);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int s = s_begin; s < s_end; ++s) {
    const float* dcs = dc + (size_t)s * cout * len;
    const T* xs = x + (size_t)s * cin * len;
    for (int t0 = 0; t0 < len; t0 += kBK) {
      __syncthreads();
      for (int e = tid; e < kBK * kBM; e += kThreads) {
        const int m = e / kBK;
        const int kk = e - m * kBK;
        const int o = m0 + m;
        const int t = t0 + kk;
        as[kk][m] = (o < cout && t < len) ? round_to<T>(dcs[(size_t)o * len + t]) : 0.f;
      }
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int jj = e / kBK;
        const int kk = e - jj * kBK;
        const int j = j0 + jj;
        const int t = t0 + kk;
        float v = 0.f;
        if (j < ncols && t < len) {
          const int i = j / 3;
          const int ts = t + (j - 3 * i) - 1;
          if (ts >= 0 && ts < len) v = to_f32(xs[(size_t)i * len + ts]);
        }
        bs[kk][jj] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = as[kk][ty * 4 + r];
          bv[r] = bs[kk][tx * 4 + r];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int o = m0 + ty * 4 + r;
    if (o >= cout) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (j < ncols) part[((size_t)z * cout + o) * ncols + j] = acc[r][c];
    }
  }
}

// dw pass, stage 2: dw = sum over the splits, in split order.
__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                 int count, int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int z = 0; z < nsplit; ++z) v += part[(size_t)z * count + i];
  dw[i] = v;
}

// db[o] = sum over samples and steps of dc[n, o, t]: one block per channel.
__global__ void __launch_bounds__(kThreads)
db_kernel(const float* __restrict__ dc, float* __restrict__ db, int n, int cout, int len) {
  __shared__ float red[kWarps];
  const int o = blockIdx.x;
  float v = 0.f;
  for (int s = 0; s < n; ++s) {
    const float* row = dc + ((size_t)s * cout + o) * len;
    for (int t = threadIdx.x; t < len; t += kThreads) v += row[t];
  }
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += red[i];
    db[o] = total;
  }
}

// ---- host launchers ---------------------------------------------------------

bool shape_ok(int n, int cin, int cout, int len) {
  return n > 0 && n <= 65535 && cin > 0 && cout > 0 && len > 0 && len <= kMaxTpt * kThreads;
}

// Runs the statement with TPT (time steps per thread) set for len.
#define SCGRHC_TPT_SWITCH(len, ...)                         \
  switch (((len) + kThreads - 1) / kThreads) {              \
    case 1: { constexpr int TPT = 1; __VA_ARGS__; } break;  \
    case 2: { constexpr int TPT = 2; __VA_ARGS__; } break;  \
    case 3: { constexpr int TPT = 3; __VA_ARGS__; } break;  \
    case 4: { constexpr int TPT = 4; __VA_ARGS__; } break;  \
    default: return cudaErrorInvalidValue;                  \
  }

template <typename T, int MODE>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y, int n,
                       int cin, int cout, int len, cudaStream_t stream) {
  const dim3 grid((cout + kOTile - 1) / kOTile, n);
  SCGRHC_TPT_SWITCH(len, fwd_kernel<T, MODE, TPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), cin, cout, len));
  return cudaGetLastError();
}

// The backward of one layer: dc into the f32 scratch dc (n, cout, len),
// then dx (n, cin, len) in T unless dx is null, then dw (cout, cin, 3) and
// db (cout,) in f32 unless dw is null, through the f32 scratch part
// (nsplit, cout, 3 * cin).
template <typename T, int MODE>
cudaError_t launch_bwd(const void* x, const void* w, const void* b, const void* dy,
                       void* dx, void* dw, void* db, void* dc, void* part, int n,
                       int cin, int cout, int len, int nsplit, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  const T* dyp = static_cast<const T*>(dy);
  float* dcp = static_cast<float*>(dc);
  if constexpr (MODE == kLinear) {
    const size_t count = (size_t)n * cout * len;
    dc_linear_kernel<T><<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        dyp, dcp, count);
  } else {
    const dim3 grid((cout + kOTile - 1) / kOTile, n);
    SCGRHC_TPT_SWITCH(len, dc_kernel<T, MODE, TPT><<<grid, kThreads, 0, stream>>>(
        xp, wp, bp, dyp, dcp, cin, cout, len));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dx != nullptr) {
    const dim3 grid((cin + kOTile - 1) / kOTile, n);
    SCGRHC_TPT_SWITCH(len, dx_kernel<T, TPT><<<grid, kThreads, 0, stream>>>(
        dcp, wp, static_cast<T*>(dx), cin, cout, len));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr) {
    const int ncols = 3 * cin;
    const dim3 grid((cout + kBM - 1) / kBM, (ncols + kBN - 1) / kBN, nsplit);
    dw_partial_kernel<T><<<grid, kThreads, 0, stream>>>(dcp, xp, static_cast<float*>(part), n,
                                                        cin, cout, len, nsplit);
    const int count = cout * ncols;
    dw_reduce_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const float*>(part), static_cast<float*>(dw), count, nsplit);
    db_kernel<<<cout, kThreads, 0, stream>>>(dcp, static_cast<float*>(db), n, cout, len);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace
}  // namespace scgrhc

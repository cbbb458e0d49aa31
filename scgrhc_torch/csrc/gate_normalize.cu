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
// (9.0 MB at N = 300, C = 4, T = 750: 2.7 us at 3.35 TB/s).  At the data
// stage's sizes (one launch per chamber interval, a few hundred windows)
// all blocks run in one wave, so a block's chain of dependent phases and
// the instructions it issues, not the card's byte rate, set the time; the
// design keeps both short.
//
// Design: one block of kThreads threads per window (the grid has N blocks
// and nothing crosses blocks), in three phases with four barriers at
// T = 750:
//   1. One read of the inputs, every load of a thread in flight at once.
//      The scg window goes to registers, 16-byte loads where the window is
//      aligned (C T % 4 == 0); the registers hold kHeldFloats<kThreads>
//      values a thread, C T <= 6,144 at 256 threads (C = 4 up to
//      T = 1,536), and past that the rest of the window is read again in
//      phase 2.  The rhc window goes to dynamic shared memory, up to
//      gate_stage_max_len(win) samples (49,468 at win = 50); a longer one
//      is read again from global memory (L2) in the later phases.  Each
//      thread folds its sum, min and max of both; one combined block
//      reduction (a warp butterfly over the five values, one barrier, then
//      a butterfly over the warps' values in every warp) gives every thread
//      (sum, lo, hi, scg lo, scg hi).  The range test needs no sum of its
//      own: a sample is below min_rhc exactly when lo is (a window holding
//      a NaN has a NaN lo, and is dropped as straight whatever that says).
//   2. The normalizing writes at once, the scg values from the registers
//      and the rhc values from shared memory, so the stores drain while the
//      gate is computed; with the rhc values, the centred OLS sums (sxx,
//      sxy, syy) against the sample index.
//   3. The flat scan: a sparse table of power-of-two windows (as the JAX
//      kernel's doubling, dsp.py:47-60), widened by 8, 4 or 2, the most
//      that keeps the width within `win`, in ping-pong shared-memory
//      buffers with one barrier a level (widths 8, 32 at win = 50), then
//      range(p) = max(M[p], M[p + win - w]) - min(m[p], m[p + win - w]).
//      O(T log win) per window: no position scans its `win` samples.
//      Positions go in tiles of kTilePositions, so the buffers stay 33.5 KB
//      at any T.  A second combined reduction (sxx, sxy, syy, flat count,
//      one barrier) ends at thread 0, which writes keep and the pairs.
// Sums are f32 in a fixed order, so repeated launches give the same bits,
// and an r^2 within rounding of 0.8 may decide the other way than the
// plain version; min, max and the normalizing division are exact (IEEE
// division, no fast math), so (lo, hi), the flat count and the normalized
// values equal the plain version's.
//
// Launch shape: 256 threads a window, chosen by timing on an H100
// (scgrhc_torch/bench/gate_layouts.cu, the same outputs bit for bit): at
// the main path's 300 windows it is the fastest of 32 (a warp a window),
// 128, 256 and 512 threads; 128 threads win from a few thousand windows
// up, where more blocks fit an SM, but the data stage launches one chamber
// interval, a few hundred windows, at a time.  A van Herk / Gil-Werman
// flat scan (a running max and min over blocks of `win`, O(T)) timed no
// faster at N = 300 and slower at N = 19,200: its 50-step chains run in a
// few lanes while the block waits.
//
// NaN: jnp.min/jnp.max propagate NaN, CUDA's fminf/fmaxf drop it.  The
// kernel's min/max are min.NaN/max.NaN (one instruction each on sm_80 and
// later), which give NaN when either side is NaN, an associative rule, so
// a window holding one has NaN (lo, hi) and all-NaN normalized values, a
// NaN sliding range wherever the NaN lies in the `win` samples (never flat
// there), and a NaN r^2 denominator (straight, so keep = false), as in JAX.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace gate {

constexpr float kNormEps = 1e-4f;
constexpr float kFlatThreshold = 1e-3f;
constexpr float kR2Threshold = 0.8f;
constexpr int kTilePositions = 2048;  // flat-scan positions per tile
constexpr int kSmemOptin = 232448;    // a block's shared-memory opt-in limit on sm_90
constexpr int kStaticReserve = 1024;  // the reduction buffers' static shared memory, with room

// The longest rhc window staged in shared memory beside the scan buffers
// (mirrored by scgrhc_torch.ops.kernels.dsp.gate_stage_max_len).
constexpr int stage_max_len(int win) {
  return (kSmemOptin - kStaticReserve - 4 * (kTilePositions + win - 1) * 4) / 4;
}

// scg values a thread holds in registers between its read and its write.
template <int kThreads>
constexpr int kHeldFloats = 6144 / kThreads < 4 ? 4 : 6144 / kThreads > 48 ? 48 : 6144 / kThreads;

// min/max that give NaN when either side is NaN: one instruction each
// (min.NaN / max.NaN, sm_80 and later)
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ void fold(float v, float& lo, float& hi) {
  lo = nan_min(lo, v);
  hi = nan_max(hi, v);
}
__device__ __forceinline__ void fold(float4 v, float& lo, float& hi) {
  fold(v.x, lo, hi);
  fold(v.y, lo, hi);
  fold(v.z, lo, hi);
  fold(v.w, lo, hi);
}
__device__ __forceinline__ float norm(float v, float lo, float den) { return (v - lo) / den; }
__device__ __forceinline__ float4 norm(float4 v, float lo, float den) {
  return make_float4(norm(v.x, lo, den), norm(v.y, lo, den), norm(v.z, lo, den),
                     norm(v.w, lo, den));
}

// (sum, min, max, min, max) of v and of lane ^ o's v
__device__ __forceinline__ void combine5(float (&v)[5], int o) {
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  v[1] = nan_min(v[1], __shfl_xor_sync(0xffffffffu, v[1], o));
  v[2] = nan_max(v[2], __shfl_xor_sync(0xffffffffu, v[2], o));
  v[3] = nan_min(v[3], __shfl_xor_sync(0xffffffffu, v[3], o));
  v[4] = nan_max(v[4], __shfl_xor_sync(0xffffffffu, v[4], o));
}

// f(i, p[i]) for i = begin + threadIdx.x, then every kThreads-th index below
// count, in order, with kBatch loads in flight before any is used.
template <int kThreads, int kBatch, typename V, typename F>
__device__ __forceinline__ void for_each(const V* p, int begin, int count, F f) {
  for (int base = begin + threadIdx.x; base < count; base += kBatch * kThreads) {
    V v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (base + j * kThreads < count) v[j] = p[base + j * kThreads];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (base + j * kThreads < count) f(base + j * kThreads, v[j]);
  }
}

// One level of the sparse table: entries of width `cur` (src) become entries
// of width K * cur (dst), len_out of them.  kSamples: src is the samples,
// whose width-1 max and min are the sample itself.
template <int kThreads, int K, bool kSamples>
__device__ __forceinline__ void widen(const float* src_hi, const float* src_lo, float* dst_hi,
                                      float* dst_lo, int cur, int len_out) {
  for (int i = threadIdx.x; i < len_out; i += kThreads) {
    float h = src_hi[i], l = kSamples ? h : src_lo[i];
#pragma unroll
    for (int j = 1; j < K; ++j) {
      const float vh = src_hi[i + j * cur];
      h = nan_max(h, vh);
      l = nan_min(l, kSamples ? vh : src_lo[i + j * cur]);
    }
    dst_hi[i] = h;
    dst_lo[i] = l;
  }
}

template <int kThreads, bool kSamples>
__device__ __forceinline__ void widen_by(int k, const float* src_hi, const float* src_lo,
                                         float* dst_hi, float* dst_lo, int cur, int len_out) {
  if (k == 8)
    widen<kThreads, 8, kSamples>(src_hi, src_lo, dst_hi, dst_lo, cur, len_out);
  else if (k == 4)
    widen<kThreads, 4, kSamples>(src_hi, src_lo, dst_hi, dst_lo, cur, len_out);
  else
    widen<kThreads, 2, kSamples>(src_hi, src_lo, dst_hi, dst_lo, cur, len_out);
}

// The number of positions p in [0, np) whose `win` samples x[p ..] span
// less than the flat threshold (NaN spans never count); this thread's
// share.  x is the rhc window from the tile's first position (shared or
// global memory); buf holds four arrays of np + win - 1 floats.  Every
// thread must call it (barriers).
template <int kThreads>
__device__ int flat_count(const float* x, float* buf, int buf_len, int np, int win) {
  float* a_hi = buf;
  float* a_lo = a_hi + buf_len;
  float* b_hi = a_lo + buf_len;  // b_lo follows it
  const float* s_hi = x;  // the entries of width cur, as (max, min)
  const float* s_lo = x;
  int cur = 1;
  while (cur * 2 <= win) {
    const int k = cur * 8 <= win ? 8 : cur * 4 <= win ? 4 : 2;
    const int len_out = np + win - cur * k;
    if (cur == 1)
      widen_by<kThreads, true>(k, x, x, a_hi, a_lo, 1, len_out);
    else
      widen_by<kThreads, false>(k, s_hi, s_lo, a_hi, a_lo, cur, len_out);
    __syncthreads();
    s_hi = a_hi;
    s_lo = a_lo;
    a_hi = s_hi == buf ? b_hi : buf;  // ping-pong
    a_lo = a_hi + buf_len;
    cur *= k;
  }
  const int off = win - cur;  // [p, p + cur) and [p + off, p + win) cover the window
  int flat = 0;
  for (int i = threadIdx.x; i < np; i += kThreads) {
    const float h = nan_max(s_hi[i], s_hi[i + off]);
    const float l = nan_min(s_lo[i], s_lo[i + off]);
    flat += (h - l) < kFlatThreshold;  // false for a NaN range
  }
  return flat;
}

template <int kThreads, bool kStaged, bool kVec4>
__global__ void __launch_bounds__(kThreads)
gate_normalize_kernel(const float* __restrict__ scg, const float* __restrict__ rhc,
                      float* __restrict__ scg_out, float* __restrict__ rhc_out,
                      unsigned char* __restrict__ keep, float* __restrict__ mm_scg,
                      float* __restrict__ mm_rhc, int m, int t, int win, int buf_len,
                      float min_rhc) {
  using V = typename std::conditional<kVec4, float4, float>::type;
  constexpr int kWarps = kThreads / 32;
  constexpr int kHeld = kHeldFloats<kThreads> / (kVec4 ? 4 : 1);
  constexpr int kBatch = (1024 + kThreads - 1) / kThreads;  // T <= 1024: one batch
  extern __shared__ float smem[];
  float* s_rhc = smem;  // the window's t rhc samples when kStaged
  float* s_buf = smem + (kStaged ? t : 0);
  __shared__ float red1[5][kWarps];
  __shared__ float red2[kWarps][3];
  __shared__ int red2_flat[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t n = blockIdx.x;
  const float* r = rhc + n * t;
  const V* sv = reinterpret_cast<const V*>(scg + n * m);
  const int mv = kVec4 ? m / 4 : m;

  // 1. one read, every load of a thread in flight at once: scg held in
  // registers, rhc staged, both folded
  V held[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (j * kThreads + tid < mv) held[j] = sv[j * kThreads + tid];
  float sum = 0.f, lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for_each<kThreads, kBatch>(r, 0, t, [&](int i, float v) {
    if (kStaged) s_rhc[i] = v;
    sum += v;
    fold(v, lo, hi);
  });
  float s_lo = CUDART_INF_F, s_hi = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (j * kThreads + tid < mv) fold(held[j], s_lo, s_hi);
  for_each<kThreads, 4>(sv, kHeld * kThreads, mv, [&](int, V v) { fold(v, s_lo, s_hi); });

  // the block's (sum, lo, hi, scg lo, scg hi): a butterfly within each
  // warp, one barrier, then a butterfly over the warps' values in every
  // warp; a fixed order, so the same bits every launch
  float v5[5] = {sum, lo, hi, s_lo, s_hi};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) combine5(v5, o);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 5; ++k) red1[k][warp] = v5[k];
  }
  __syncthreads();  // also publishes s_rhc
#pragma unroll
  for (int k = 0; k < 5; ++k) v5[k] = red1[k][lane & (kWarps - 1)];
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) combine5(v5, o);
  sum = v5[0];
  lo = v5[1];
  hi = v5[2];
  s_lo = v5[3];
  s_hi = v5[4];
  // any sample below min_rhc: the window's min is; a NaN window (lo NaN)
  // is dropped as straight whatever this says
  const bool below = lo < min_rhc;
  const float* x = kStaged ? s_rhc : r;  // the rhc window from here on

  // 2. the normalizing writes; with the rhc values, the centred OLS sums
  // against the sample index
  const float s_den = s_hi - s_lo + kNormEps;
  V* so = reinterpret_cast<V*>(scg_out + n * m);
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (j * kThreads + tid < mv) so[j * kThreads + tid] = norm(held[j], s_lo, s_den);
  for_each<kThreads, 4>(sv, kHeld * kThreads, mv,
                        [&](int i, V v) { so[i] = norm(v, s_lo, s_den); });
  const float den = hi - lo + kNormEps;
  const float mean = sum / (float)t;
  const float x_mid = (float)(t - 1) * 0.5f;
  float* ro = rhc_out + n * t;
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
  for_each<kThreads, kBatch>(x, 0, t, [&](int i, float v) {
    ro[i] = norm(v, lo, den);
    const float xc = (float)i - x_mid;
    const float yc = v - mean;
    sxx += xc * xc;
    sxy += yc * xc;
    syy += yc * yc;
  });

  // 3. the flat scan, a tile of positions at a time
  int flat = 0;
  const int npos = t - win + 1;
  for (int p0 = 0; p0 < npos; p0 += kTilePositions) {
    const int np = min(npos - p0, kTilePositions);
    flat += flat_count<kThreads>(x + p0, s_buf, buf_len, np, win);
    if (p0 + kTilePositions < npos) __syncthreads();  // the next tile rewrites the buffers
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sxx += __shfl_xor_sync(0xffffffffu, sxx, o);
    sxy += __shfl_xor_sync(0xffffffffu, sxy, o);
    syy += __shfl_xor_sync(0xffffffffu, syy, o);
    flat += __shfl_xor_sync(0xffffffffu, flat, o);
  }
  if (lane == 0) {
    red2[warp][0] = sxx;
    red2[warp][1] = sxy;
    red2[warp][2] = syy;
    red2_flat[warp] = flat;
  }
  __syncthreads();
  if (tid == 0) {
    sxx = red2[0][0];
    sxy = red2[0][1];
    syy = red2[0][2];
    flat = red2_flat[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      sxx += red2[w][0];
      sxy += red2[w][1];
      syy += red2[w][2];
      flat += red2_flat[w];
    }
    const float denom = sxx * syy;
    const float r2 = denom > 0.f ? (sxy * sxy) / denom : 1.f;  // NaN denom: 1
    keep[n] = !(flat >= 2 || r2 > kR2Threshold || below);
    mm_rhc[2 * n] = lo;
    mm_rhc[2 * n + 1] = hi;
    mm_scg[2 * n] = s_lo;
    mm_scg[2 * n + 1] = s_hi;
  }
}

// An empty kernel on K3's grid: the card's launch floor, for timing only.
__global__ void empty_kernel() {}

using Kernel = void (*)(const float*, const float*, float*, float*, unsigned char*, float*,
                        float*, int, int, int, int, float);

template <int kThreads, bool kStaged>
Kernel pick(bool vec4) {
  return vec4 ? gate_normalize_kernel<kThreads, kStaged, true>
              : gate_normalize_kernel<kThreads, kStaged, false>;
}

// K3 on n windows of c x t scg and t rhc samples, kThreads threads a window.
template <int kThreads>
cudaError_t launch(const float* scg, const float* rhc, float* scg_out, float* rhc_out,
                   unsigned char* keep, float* mm_scg, float* mm_rhc, int n, int c, int t,
                   int win, float min_rhc, cudaStream_t stream) {
  if (n <= 0 || c <= 0 || t <= 0 || win <= 0 || (long long)c * t > INT_MAX)
    return cudaErrorInvalidValue;
  const int m = c * t, npos = t - win + 1;
  const int buf_len = npos > 0 ? (npos < kTilePositions ? npos : kTilePositions) + win - 1 : 0;
  const bool staged = t <= stage_max_len(win);
  const bool vec4 = m % 4 == 0 && reinterpret_cast<uintptr_t>(scg) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(scg_out) % 16 == 0;
  const Kernel kernel = staged ? pick<kThreads, true>(vec4) : pick<kThreads, false>(vec4);
  const size_t bytes = ((staged ? (size_t)t : 0) + 4 * (size_t)buf_len) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin - kStaticReserve);
    if (e != cudaSuccess) return e;
  }
  kernel<<<n, kThreads, bytes, stream>>>(scg, rhc, scg_out, rhc_out, keep, mm_scg, mm_rhc, m, t,
                                         win, buf_len, min_rhc);
  return cudaGetLastError();
}

constexpr int kThreads = 256;  // the launch shape (see the header)

}  // namespace gate

// scg (n, c, t) and rhc (n, t) float32, contiguous; scg_out and rhc_out the
// same shapes; keep (n,) bytes; mm_scg and mm_rhc (n, 2) float32.  Any t
// with c * t < 2^31.  Returns the launch's cudaError_t (0 on success); it
// does not synchronise.
extern "C" int scgrhc_gate_normalize(const void* scg, const void* rhc, void* scg_out,
                                     void* rhc_out, void* keep, void* mm_scg, void* mm_rhc,
                                     int n, int c, int t, int win, float min_rhc,
                                     void* stream) {
  return (int)gate::launch<gate::kThreads>(
      static_cast<const float*>(scg), static_cast<const float*>(rhc),
      static_cast<float*>(scg_out), static_cast<float*>(rhc_out),
      static_cast<unsigned char*>(keep), static_cast<float*>(mm_scg),
      static_cast<float*>(mm_rhc), n, c, t, win, min_rhc, static_cast<cudaStream_t>(stream));
}

// The empty kernel on K3's grid (n blocks of its threads), for the launch
// floor beside K3's time.
extern "C" int scgrhc_gate_normalize_floor(int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  gate::empty_kernel<<<n, gate::kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

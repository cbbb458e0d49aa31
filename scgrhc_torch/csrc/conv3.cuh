// Device code of the conv1d(k=3, padding=1) layer kernels (conv_layer.cu):
// the generator's conv + InstanceNorm + ReLU layer (K1f, K1b) and the
// critic's layer in its three modes (K2f, K2dx, K2dw).  Layouts are PyTorch's: x (N, C, T), w (O, C, 3), b (O,).
//
// Modes, for c = conv1d(x, w, padding=1) + b:
//   linear   y = c
//   relu     y = relu(c)
//   in_relu  y = relu((c - mean_T c) * rsqrt(var_T c + 1e-5)), one-pass
//            biased statistics in f32 (var = max(E[c^2] - mean^2, 0))
// The generator's layer is the in_relu mode.
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
// One conv core computes c and dx for both models: an implicit GEMM on the
// tensor cores (conv_mma_kernel; its note is above it), on Hopper's
// warpgroup MMA over (T, O) tiles in f32 and on mma.sync over (O, T)
// tiles in bf16, with conv_stream_kernel and dx_stream_kernel for the
// forward and dx below 16 output channels, then row_kernel for the modes
// that need a whole row
// of c, which goes through an f32 scratch (the in_relu forward's rows past
// kRowPiece steps in pieces: row_part_kernel, row_sum_kernel,
// row_apply_kernel).  No pass
// holds a whole row of c, so T has no limit; the launchers walk N in chunks of 65535 samples
// (launch_layer_fwd, launch_layer_bwd).
// The dw pass (its own note is above dw_mma_kernel) is split over samples
// into per-block partial sums that a second kernel adds in a fixed order.
// No pass uses float atomics, so a run gives the same bits every time.
//
// NaN propagates as in the plain versions: a relu is `v < 0 ? 0 : v` and a
// mask is a multiply by (v > 0 ? 1 : 0), never fmaxf.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace scgrhc {

// The f32 dw stage's launches by how its rows were copied, over every
// source of the library (conv_layer.cu: scgrhc_dw_copy_launches): by
// the TMA unit's boxes; by cp.async where no tensor map fits the shape
// or the alignment (odd T, an odd channel count with row pairs, tensors
// not 16-byte aligned); by cp.async where a map fits but could not be
// made (the driver gave no cuTensorMapEncodeTiled, or it failed).
enum DwCopy { kDwCopyTma = 0, kDwCopyRows = 1, kDwCopyNoMap = 2 };
inline std::atomic<long long> dw_copy_launches[3];

namespace {  // internal linkage: each including source has its own copy

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

template <typename T>
__global__ void dc_linear_kernel(const T* __restrict__ dy, float* __restrict__ dc, size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dc[i] = to_f32(dy[i]);
}

// ---- dw pass ----------------------------------------------------------------
//
// dw[o, i, k] = sum_{n,t} dc[n, o, t] * x[n, i, t + k - 1] is a product
// with M = O, N = 3 * C_in and K = N * T, both operands contiguous along
// K.  Stage 1 writes per-split partial sums part[z][o][j], j = i * 3 + k
// (dw's layout), over the samples [n*z/nsplit, n*(z+1)/nsplit); stage 2
// (dw_reduce_kernel) adds the splits in split order.  Three stage-1 paths,
// chosen by dw_plan (conv3.py's dw_plan mirrors it) from the dtype and
// the number of output channels:
//
// f32 from kDwStreamBelow output channels (every generator layer; the
// critic's 4->64 .. 256->512 and the linear dw of K2dx's vjp):
// dw_mma_kernel<DwWgTile>, the product on Hopper's warpgroup MMA (wgmma
// m64n64k8, TF32).
//   Bound: operations.  A train.w06 step (B 64, T 750) runs 720 GFLOP of
//   dw, 4.36 ms at the 3xTF32 rate (495/3 TFLOP/s); 256->512 at N = 64 is
//   37.7 GFLOP against 147 MB of dc and x: 0.229 ms against 0.044.
//   Design (its note is above DwWgTile): a block of three consumer
//   warpgroups (one a tap: A = x at the tap's shift, from registers, split
//   once into big + small) and a producer warpgroup (the TMA unit copies a
//   stage's 64 x rows and 64 dc rows as 2-D boxes of tensor maps; the
//   producers split dc into its big and small planes in wgmma's layout);
//   tiles of 64 x 64 channels, stages of 64 steps, 3 a ring, summed in two
//   batches of 32 steps that the stage's sums carry (from zero; 64 steps
//   on the tensor cores at most), then added in f32; a persistent grid of
//   one block an SM over (tile, split) items; setmaxnreg gives the
//   consumers 136 registers (the producers keep 104).
//   Timed on an H100 (bench/dw_tiles.cu, N = 64, ms with the reduce, %
//   of the 3xTF32 rate; in brackets DwMain, the f32 mma.sync tiling this
//   replaced): 256->512 at T = 744 0.433 (52 %; 1.044, 22 %), at T = 750
//   0.448 (51 %; 1.040); 512->512 0.825 (55 %; 2.068); 512->256 0.447 (51
//   %; 1.043); 256->256 0.236 (48 %; 0.527); 128->256 0.129 (44 %; 0.271);
//   128->128 0.069 (41 %; 0.145); 64->128 0.044 (32 %; 0.083); 64->64
//   0.043 (17 %; 0.050: one tile, 64 blocks).  At N = 32: 256->512 0.222
//   (51 %; 0.531), 512->512 0.425 (54 %; 1.028), 128->128 0.042 (34 %;
//   0.081), 64->128 0.038 (19 %; 0.049).  The first layers (3 * C_in = 9
//   to 15 of a tile's 192 columns) at T = 750: 4->64 0.037 (0.042); 3->64
//   and 5->64 0.062 (0.042), an odd channel count giving no row pairs and
//   so cp.async rows.  A train.w06 step runs 3->64 once and 4->64 eight
//   times: 0.02 ms less than on mma.sync, so f32 takes no second path.
//   Tilings timed against this one and left out: the registers split
//   evenly (128 a thread, no setmaxnreg) 9-15 % slower; a stage's 8 k8
//   steps in one batch (152 registers) 4-5 %; stages of 32 steps 14-17 %;
//   with 32-step stages, one copy a row a stage (by the TMA unit or by
//   cp.async) in place of the maps' boxes held the kernel at 25-31 %; this
//   tiling with cp.async rows (tensors not 16-byte aligned) 20-25 %.  Of
//   the two maps of the product first timed (both with cp.async rows), dc
//   from registers with x's three shifted images in shared memory (N = 96
//   columns: 32 channels x 3 taps) ran at 25 % where this one ran at 23 %;
//   with the copies left out (their cost measured so) this one ran at 52
//   % against 47 %, its producers making two planes a stage where the
//   other makes six.
//
// bf16 from kDwStreamBelow output channels: dw_mma_kernel<DwTile>, the
// product on tensor cores with mma.sync (m16n8k16 on dc rounded to bf16,
// the contract's rounding, and x; f32 accumulation).
//   Bound: operations.  The f32 FMA kernel it first replaced ran at 11 % of
//   the f32 peak, held back by scalar shared loads, a gathered im2col (x
//   fetched three times) and no overlap of loads and math.
//   Design (DwMain): a block owns 64 output channels x 32 input channels x
//   3 taps, 8 warps of 32 rows x 8 channels x 3 taps.  64 rows: the O = 64
//   layers would leave half of a 128-row tile empty.  Timed on an H100 in
//   f32 (bench/dw_tiles.cu before the warpgroup MMA): the fastest of five
//   tilings at 64->128, where the larger tiles give too few blocks
//   (1.6-2.7x slower); at 256->512 and 512->512, 64 x 64 is 11 % faster
//   and 128 x 64 (253 registers, one block an SM) 20 %.  Per slice of 64
//   steps it stages dc (64 x 64) and an x slab (32 x 68, with its zero
//   halo) once, and the three taps read the slab at offsets 0, 1 and 2, so
//   each value comes from device memory once per block.  A 3-stage
//   cp.async ring (78 KB, two blocks an SM) keeps two slices in flight
//   under the mma of a third, dc in 8-byte copies where T is even.
//
// On both tensor-core paths db comes from db_kernel, one more pass over dc.
//
// O < kDwStreamBelow (the critic's 512 -> 1 score layer): dw_stream_kernel.
//   Bound: bytes.  x is 49 MB at N=32, T=750 against 3 FMAs per value:
//   14.7 us at 3.35 TB/s.  A 64-row tile would leave 63 rows empty and
//   fetch x three times.
//   Design: x is read once, in vector loads (16 or 8 bytes as T allows).
//   A block holds one sample's dc (O x (T+2), zero halo) in shared memory
//   and gives each warp one x row at a time: three shifted dot products per
//   output channel, reduced across the warp and added to the block's sums
//   in a fixed order.  Blocks over (32-channel slab, sample split), about
//   four per SM; db comes from the same dc in shared memory and goes into
//   part's last column, so one reduce gives dw and db.

constexpr int kDwStreamBelow = 16;  // O below this takes the streaming path
constexpr int kDwStreamC = 32;      // input channels of a streaming block

// The bf16 mma.sync path's tiling: a block of kThreads owns BM output
// channels x BC input channels (x 3 taps) and walks slices of BK steps
// through a ring of STAGES buffers; WROWS warps split the rows, the rest
// the channels.  A stage holds a[m][kk] = dc[s, o0 + m, t0 + kk] and
// x[c][j] = x[s, c0 + c, t0 - 2 + j] (zero outside [0, T)), rows padded to
// kLd = BK + 4 floats: kLd = 4 (mod 32) puts a fragment's 32 lanes on 32
// banks, and the 2-step offset of x keeps 8-byte copies aligned.
template <int BM_, int BC_, int BK_, int STAGES_, int WROWS_, int MINB_>
struct DwTile {
  static constexpr int BM = BM_, BC = BC_, BK = BK_, STAGES = STAGES_, WROWS = WROWS_;
  static constexpr int MINB = MINB_;                     // blocks per SM to fit registers for
  static constexpr int kMI = BM / WROWS / 16;            // m16 tiles per warp
  static constexpr int kNI = BC / (kWarps / WROWS) / 8;  // n8 tiles per warp
  static constexpr int kLd = BK + 4;
  static constexpr int kStage = (BM + BC) * kLd;  // floats
  static constexpr int kSmemBytes = (int)sizeof(float) * STAGES * kStage;
  static_assert(kLd % 32 == 4 && kMI >= 1 && kNI >= 1, "DwTile: bad shape");
};

// 4-byte asynchronous copy; zero-fills the destination when !full.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 4 : 0));
}
// 8-byte asynchronous copy; both addresses 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool full) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(full ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned to_tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = big + small, both TF32: the 3xTF32 split
__device__ __forceinline__ void split_tf32(float v, unsigned& big, unsigned& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage slice (sample s, steps t0 ..) of dc and x into the stage at st.
// PAIRS (T even, pointers 8-byte aligned): dc goes in 8-byte copies, each
// pair wholly inside or outside [0, T) as t0 is even.  bf16 x is converted
// on its way in, with plain loads: cp.async cannot convert.
template <typename Tile, bool PAIRS>
__device__ __forceinline__ void dw_fill(float* st, const float* __restrict__ dc,
                                        const __nv_bfloat16* __restrict__ x, int s, int t0,
                                        int o0, int c0, int cin, int cout, int len) {
  constexpr int kLd = Tile::kLd, W = PAIRS ? 2 : 1;
  const float* dcs = dc + (size_t)s * cout * len;
#pragma unroll
  for (int e = threadIdx.x; e < Tile::BM * Tile::BK / W; e += kThreads) {
    const int m = e / (Tile::BK / W), kk = e % (Tile::BK / W) * W;
    const bool in = o0 + m < cout && t0 + kk < len;
    const float* src = in ? dcs + (size_t)(o0 + m) * len + t0 + kk : dc;
    if constexpr (PAIRS)
      cp_async8(st + m * kLd + kk, src, in);
    else
      cp_async4(st + m * kLd + kk, src, in);
  }
  float* xs = st + Tile::BM * kLd;
  const __nv_bfloat16* xn = x + (size_t)s * cin * len;
#pragma unroll
  for (int e = threadIdx.x; e < Tile::BC * kLd; e += kThreads) {
    const int c = e / kLd, j = e % kLd, t = t0 - 2 + j;
    const bool in = c0 + c < cin && t >= 0 && t < len;
    xs[c * kLd + j] = in ? to_f32(xn[(size_t)(c0 + c) * len + t]) : 0.f;
  }
}

// acc[mi][ni][tap] += the warp's share of the staged slice at st: rows
// (wr * kMI + mi) * 16 .., channels (wc * kNI + ni) * 8 .., three taps.
// g = lane / 4 and q = lane % 4 index the fragments as the PTX ISA lays
// them out.
template <typename Tile>
__device__ __forceinline__ void dw_mma_slice(const float* st, int wr, int wc, int g, int q,
                                             float (&acc)[Tile::kMI][Tile::kNI][3][4]) {
  constexpr int kLd = Tile::kLd, kMI = Tile::kMI, kNI = Tile::kNI;
  const float* A = st + (wr * kMI * 16 + g) * kLd;
  // column j of x is step t0 - 2 + j: tap k of step t0 + kk reads kk + k + 1
  const float* X = st + (Tile::BM + wc * kNI * 8 + g) * kLd + 1;
#pragma unroll
  for (int kk = 0; kk < Tile::BK; kk += 16) {
    unsigned a[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const float* r = A + mi * 16 * kLd + kk + 2 * q;
      a[mi][0] = pack_bf16(r[0], r[1]);
      a[mi][1] = pack_bf16(r[8 * kLd], r[8 * kLd + 1]);
      a[mi][2] = pack_bf16(r[8], r[9]);
      a[mi][3] = pack_bf16(r[8 * kLd + 8], r[8 * kLd + 9]);
    }
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const float* xr = X + ni * 8 * kLd + kk + 2 * q + tap;
        const unsigned b0 = pack_bf16(xr[0], xr[1]);
        const unsigned b1 = pack_bf16(xr[8], xr[9]);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) mma_bf16(acc[mi][ni][tap], a[mi], b0, b1);
      }
    }
  }
}

// Stage 1 in bf16 on mma.sync: one block per (BM output channels, BC
// input channels, sample split), walking the split's (sample, slice) pairs
// in order through the cp.async ring.  Each slice's products sum from zero
// in the tensor cores and are added to the block's sums with an f32 add:
// the tensor cores' own accumulation rounds less finely than f32 (one
// running sum over 5952 steps read 1.4e-5 from the f32 product at 512 ->
// 512).
template <typename Tile, bool PAIRS>
__global__ void __launch_bounds__(kThreads, Tile::MINB)
dw_mma_kernel(const float* __restrict__ dc, const __nv_bfloat16* __restrict__ x,
              float* __restrict__ part, int n, int cin, int cout, int len, int nsplit) {
  extern __shared__ __align__(16) float dw_smem[];
  constexpr int kMI = Tile::kMI, kNI = Tile::kNI, S = Tile::STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp % Tile::WROWS, wc = warp / Tile::WROWS;
  const int o0 = blockIdx.x * Tile::BM, c0 = blockIdx.y * Tile::BC, z = blockIdx.z;
  const int s0 = (int)(((long long)n * z) / nsplit);
  const int s1 = (int)(((long long)n * (z + 1)) / nsplit);
  const int slices = (len + Tile::BK - 1) / Tile::BK;
  const int nq = (s1 - s0) * slices;
  float acc[kMI][kNI][3][4] = {};

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nq)
      dw_fill<Tile, PAIRS>(dw_smem + st * Tile::kStage, dc, x, s0 + st / slices,
                           st % slices * Tile::BK, o0, c0, cin, cout, len);
    cp_async_commit();
  }
  for (int i = 0; i < nq; ++i) {
    cp_async_wait<S - 2>();  // slice i has landed
    __syncthreads();         // ... for every thread; slice i-1's stage is free
    const int next = i + S - 1;
    if (next < nq)
      dw_fill<Tile, PAIRS>(dw_smem + next % S * Tile::kStage, dc, x, s0 + next / slices,
                           next % slices * Tile::BK, o0, c0, cin, cout, len);
    cp_async_commit();
    float sl[kMI][kNI][3][4] = {};
    dw_mma_slice<Tile>(dw_smem + i % S * Tile::kStage, wr, wc, g, q, sl);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int tap = 0; tap < 3; ++tap)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][tap][e] += sl[mi][ni][tap][e];
  }

  const int ncols = 3 * cin;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = o0 + (wr * kMI + mi) * 16 + g + (e >= 2 ? 8 : 0);
          const int c = c0 + (wc * kNI + ni) * 8 + 2 * q + (e & 1);
          if (o < cout && c < cin)
            part[((size_t)z * cout + o) * ncols + c * 3 + tap] = acc[mi][ni][tap][e];
        }
}

// Launches a stage-1 kernel of dw with smem bytes of dynamic shared memory
// (allowed past 48 KB first).
template <typename T>
cudaError_t launch_dw_stage1(void (*kernel)(const float*, const T*, float*, int, int, int, int,
                                            int),
                             dim3 grid, int smem, const float* dc, const T* x, float* part,
                             int n, int cin, int cout, int len, int nsplit, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(dc, x, part, n, cin, cout, len, nsplit);
  return cudaGetLastError();
}

// Stage 1 in bf16 on mma.sync with the tiling Tile.
template <typename Tile>
cudaError_t launch_dw_mma(const float* dc, const __nv_bfloat16* x, float* part, int n, int cin,
                          int cout, int len, int nsplit, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const dim3 grid((cout + Tile::BM - 1) / Tile::BM, (cin + Tile::BC - 1) / Tile::BC, nsplit);
  const bool pairs = len % 2 == 0 && reinterpret_cast<uintptr_t>(dc) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const auto kernel = pairs ? &dw_mma_kernel<Tile, true> : &dw_mma_kernel<Tile, false>;
  return launch_dw_stage1<T>(kernel, grid, Tile::kSmemBytes, dc, x, part, n, cin, cout, len,
                             nsplit, stream);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) VecOf {
  T v[VEC];
};

// Stage 1, streaming path: one block per (32-channel slab, sample split);
// OMAX >= cout.  part rows hold 3 * cin + 1 columns, the last one db's.
template <typename T, int OMAX, int VEC>
__global__ void __launch_bounds__(kThreads)
dw_stream_kernel(const float* __restrict__ dc, const T* __restrict__ x, float* __restrict__ part,
                 int n, int cin, int cout, int len, int nsplit) {
  extern __shared__ float dcs[];  // dcs[o * (len + 2) + j] = dc[s, o, j - 1], zero halo
  __shared__ float sums[kDwStreamC][OMAX * 3];
  __shared__ float dbs[OMAX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kDwStreamC, z = blockIdx.y;
  const int s0 = (int)(((long long)n * z) / nsplit);
  const int s1 = (int)(((long long)n * (z + 1)) / nsplit);
  const int ld = len + 2;
  for (int e = threadIdx.x; e < kDwStreamC * OMAX * 3; e += kThreads) (&sums[0][0])[e] = 0.f;
  if (threadIdx.x < OMAX) dbs[threadIdx.x] = 0.f;

  for (int s = s0; s < s1; ++s) {
    __syncthreads();  // the previous sample's reads are done
    const float* dcn = dc + (size_t)s * cout * len;
    for (int e = threadIdx.x; e < cout * ld; e += kThreads) {
      const int o = e / ld, t = e - o * ld - 1;
      dcs[e] = (t >= 0 && t < len) ? dcn[(size_t)o * len + t] : 0.f;
    }
    __syncthreads();
    if (blockIdx.x == 0) {  // db: warp o % kWarps owns channel o, samples in order
      for (int o = warp; o < cout; o += kWarps) {
        float v = 0.f;
        for (int t = lane; t < len; t += 32) v += dcs[o * ld + t + 1];
        v = warp_sum(v);
        if (lane == 0) dbs[o] += v;
      }
    }
    for (int c = warp; c < kDwStreamC && c0 + c < cin; c += kWarps) {
      const T* row = x + ((size_t)s * cin + c0 + c) * len;
      float acc[OMAX][3];
#pragma unroll
      for (int o = 0; o < OMAX; ++o) acc[o][0] = acc[o][1] = acc[o][2] = 0.f;
#pragma unroll 4
      for (int v = lane; v * VEC < len; v += 32) {
        const VecOf<T, VEC> p = reinterpret_cast<const VecOf<T, VEC>*>(row)[v];
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const int t = v * VEC + u;
          const float xv = to_f32(p.v[u]);
#pragma unroll
          for (int o = 0; o < OMAX; ++o) {
            if (o < cout) {
              // x at step t meets dc at t + 1 (tap 0), t (tap 1), t - 1 (tap 2)
              const float* d = dcs + o * ld + t;
              acc[o][0] = fmaf(round_to<T>(d[2]), xv, acc[o][0]);
              acc[o][1] = fmaf(round_to<T>(d[1]), xv, acc[o][1]);
              acc[o][2] = fmaf(round_to<T>(d[0]), xv, acc[o][2]);
            }
          }
        }
      }
#pragma unroll
      for (int o = 0; o < OMAX; ++o) {
        if (o < cout) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float v = warp_sum(acc[o][k]);
            if (lane == 0) sums[c][o * 3 + k] += v;
          }
        }
      }
    }
  }
  __syncthreads();
  const int stride = 3 * cin + 1;
  for (int e = threadIdx.x; e < cout * kDwStreamC * 3; e += kThreads) {
    const int o = e / (kDwStreamC * 3), r = e - o * (kDwStreamC * 3);
    const int c = r / 3, k = r - c * 3;
    if (c0 + c < cin) part[((size_t)z * cout + o) * stride + (c0 + c) * 3 + k] = sums[c][o * 3 + k];
  }
  if (blockIdx.x == 0 && threadIdx.x < cout)
    part[((size_t)z * cout + threadIdx.x) * stride + 3 * cin] = dbs[threadIdx.x];
}

// Stage 2: the splits added in split order.  A part row of stride columns
// holds dw's 3 * cin, then (streaming path) db's partial sum.
__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                 float* __restrict__ db, int cin, int cout, int stride,
                                 int nsplit) {
  const int count = cout * stride;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = 0.f;
  for (int z = 0; z < nsplit; ++z) v += part[(size_t)z * count + i];
  const int o = i / stride, j = i - o * stride;
  if (j < 3 * cin)
    dw[o * 3 * cin + j] = v;
  else
    db[o] = v;
}

// db[o] = sum over samples and steps of dc[n, o, t] (tensor-core path):
// one block per channel.
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

// ---- the conv core ------------------------------------------------------------
//
// Replaces, with the row pass below, the conv of every layer kernel:
// scgrhc/ops/pallas/conv_block.py's _fwd_kernel (K1f) and the recompute
// and dx of its _bwd_kernel (K1b); critic_fused.py's _fwd_kernel (K2f) and
// the conv halves of _bwd_dx_kernel (K2dx: the recompute of c at the head
// of the dc pass, and dx) and of _bwd_dwdb_kernel's dc pass (K2dw).
//
// c[n, o, t] = b[o] + sum_i sum_k w[o, i, k] * x[n, i, t + k - 1] is one
// product per sample with K = 3 * C_in; dx is the same product over dc
// with the weights W(i, o, tap) = w[o, i, 2 - tap] (K = 3 * O).
//
// Bound: operations.  256 -> 512 at N = 32, T = 750 is 18.9 GFLOP a pass:
// 0.114 ms at the 3xTF32 rate (495/3 TFLOP/s), 0.28 ms at the f32 FMA
// peak, against 0.015 ms of bytes (x and y); the generator's 512 -> 512 at
// N = 512, T = 744 is 600 GFLOP, 3.6 ms at the 3xTF32 rate.
//
// f32 (conv_mma_kernel<WgTile<BN>>): the transposed product D[t][o] =
// sum_(tap, ci) X[t][(tap, ci)] * W[(tap, ci)][o] on Hopper's warpgroup MMA
// (wgmma m64nNk8, TF32), M = steps and N = output channels (dx: input
// channels).  TF32 wgmma reads shared-memory operands K-major only, and an
// x tile in the (N, C, T) layout is t-contiguous, so A, the im2col of x,
// comes from registers: each consumer thread loads its fragment from a
// shared x slab [ci][t0 - 2 .. t0 + BM + 1] at the tap's shift (a
// descriptor cannot shift by one step) and splits it into big + small
// once; each split value feeds all BN columns.  B is a copy of the weights
// that conv_weight_split_kernel arranges and splits once a launch: for
// each tile of BN columns and each stage of BC channels, an image of the
// stage's big and small planes, 3 taps each, in wgmma's K-major core
// matrices (8 columns x 4 channels, 128 bytes), so that one bulk copy
// (the TMA unit, completing on an mbarrier) brings a stage's weights.  The
// x slab goes by cp.async (8-byte copies where T is even): a tensor map
// needs row strides of a multiple of 16 bytes, which T = 750 (and 746)
// is not.  Three wgmma a tap: small*big, big*small, big*big.
//   A block is 4 producer warps and two consumer warpgroups of 64 steps
//   each (BM = 128 steps x BN columns; 256 steps below 32 columns),
//   persistent over (step tile, column tile, sample) tiles, with a ring of
//   8 stages (full and empty mbarriers): the producers fill stages ahead,
//   so a tile's epilogue overlaps the next tile's loads.  BN follows the
//   product's columns (8 .. 128), so the 64 -> 64 layers and the 4- and
//   5-channel dx fill their tiles.  Each stage's products (8 channels x 3
//   taps) sum from zero in the tensor cores and are added to the running
//   sums in f32 outside them (one running sum on the tensor cores read
//   1.45e-5 at dw).
//   Epilogue: + bias, relu where asked, stored in f32 from the fragments
//   (a thread's 8 consecutive steps of a column fill one 32-byte sector).
//   The split costs a launch of conv_weight_split_kernel a pass (0.004 ms;
//   0.43 ms in a training step's 173).
//   Timed on an H100 (bench/conv_core.cu, N = 32, T = 750, fwd at 256 ->
//   512): 128 x 128 tiles with one producer warp 0.306 ms (37 % of the
//   3xTF32 rate), against 0.528 for the mma.sync core it replaces; 64
//   columns x 256 steps 0.442 (smaller wgmma, the same bytes); 8 stages
//   against 6 2 % faster; partial sums over 2 stages 5 % faster, but 16-20 %
//   slower with 4 producer warps (ptxas serializes the wgmma there).  With
//   the x slab not reloaded (its values stale)
//   the same loop read 0.186 ms, with the weights not reloaded 0.298: one
//   warp's cp.async of x, not the bulk copies, held the pipeline.  2
//   producer warps 0.256, 4 0.218 (53 %; dx 0.194, 59 %), at 168
//   registers, the most 384 threads may take; 64 -> 64 and 64 -> 128 run
//   at 17-25 %, with 4 to 8 stages a tile.  The generator's 11 layer
//   shapes at N = 512 (the in_relu forward with row_kernel) take 20.4 ms
//   against 46.3.
// bf16 (conv_mma_kernel<MmaTile, ...>): mma.sync m16n8k16 with f32
// accumulation over (O, T) tiles of 64 x 128 steps in slices of 16
// channels x 3 taps through a 3-stage cp.async ring, each slice summed
// from zero and added in f32 (staged values rounded as round_to does: dc
// to bf16 before dx's product).
//
// The in_relu mode stores c in f32 (the wrapper's scratch, or the dc
// scratch itself) and row_kernel, a warp per (n, o) row, takes the
// one-pass statistics over T and writes y, or dc over c in place.  The
// round trip of c costs 2 x 49 MB at 256 -> 512, about 0.03 ms, and
// 2 x 780 MB at the generator's 512 -> 512 at N = 512, about 0.5 ms.
//
// Below kConvStreamBelow output channels (the 512 -> 1 score layer) the
// forward is conv_stream_kernel.  Bound: bytes, x read once (49 MB, 14.7
// us at 3.35 TB/s); a 64-row tile would leave 63 rows empty.  A block owns
// 64 steps of one sample, each lane two adjacent steps read as one vector
// where T and x's alignment allow (the halo from the neighbouring lanes by
// shuffles); its 8 warps walk 8 slabs of the input channels in order and
// their sums are added in warp order.
//
// dx below kConvStreamBelow output channels is dx_stream_kernel.  Bound:
// bytes, dx written once (49 MB at 512 -> 1, N = 32, T = 750: 14.7 us);
// on the core, K = 3 * O is a part of one 16-channel slice, and it took
// 0.0496 ms in a CUDA graph on an H100 (chip_smoke.py), twice an FMA
// kernel's 0.0236.  A block holds 64 steps of dc with their halo in shared
// memory; each warp writes whole rows of dx, each lane two steps in one
// store.

constexpr int kConvStreamBelow = 16;  // O below this: the forward streams over x
constexpr int kStreamSteps = 64;      // steps of a streaming block, two a lane

// ---- f32: warpgroup MMA ----

constexpr int kWgConsumers = 2;  // consumer warpgroups a block
constexpr int kWgBlocks = 132;   // the persistent grid: an H100's SMs
constexpr int kWgBC = 8;  // source channels a stage: one k8 step a tap

// A tiling of the f32 core (conv3.py: wg_tile_m, wg_tile_n): BN product
// columns x BM = 64 * MW * kWgConsumers steps a tile, each consumer
// warpgroup MW m64 row tiles; STAGES stages of BC = 8 source channels (one
// k8 step a tap), filled by PW producer warps.  A stage holds the
// weight image (plane, tap: BN x BC each, in core matrices: element (n, c)
// at (n / 8) * 64 + (c / 4) * 32 + (n % 8) * 4 + c % 4) and the x slab
// X[ci][j] = source channel c0 + ci at step t0 - 2 + j (zero outside [0,
// T)) in rows of kLdX floats: kLdX = 8 (mod 32) puts a fragment's 32 lanes
// on 32 banks, and the 2-step offset keeps 8-byte copies aligned.
template <int BN_, int MW_, int STAGES_, int PW_>
struct WgTile {
  static constexpr int BN = BN_, MW = MW_, STAGES = STAGES_, PW = PW_;
  static constexpr int kThreads = 128 * kWgConsumers + 32 * PW;
  static constexpr int BM = 64 * MW * kWgConsumers;  // steps a tile
  static constexpr int BC = kWgBC;
  static constexpr int kLdX = BM + 8;
  static constexpr int kXCols = BM + 4;  // filled columns: steps t0 - 2 .. t0 + BM + 1
  static constexpr int kPlane = 3 * BN * BC;   // floats of one plane's 3 taps
  static constexpr int kWFloats = 2 * kPlane;  // big and small
  static constexpr int kStage = kWFloats + BC * kLdX;
  static constexpr int kSmemBytes = (int)sizeof(float) * STAGES * kStage + 16 * STAGES;
  static_assert(BN % 8 == 0 && BN <= 128 && kLdX % 32 == 8 && kXCols <= kLdX &&
                    (kWFloats * 4) % 128 == 0 && (kStage * 4) % 128 == 0 &&
                    kSmemBytes <= 232448,
                "WgTile: bad shape");
};

// The f32 core's tile width for a product of cols columns.
int wg_tile_n(int cols) {
  return cols <= 8 ? 8 : cols <= 16 ? 16 : cols <= 32 ? 32 : cols <= 64 ? 64 : 128;
}

// The tiling the launchers take at tile width BN (timed on an H100,
// bench/conv_core.cu; the note above conv_mma_kernel): 4 producer warps,
// 8 stages, each stage's partial sums added alone; below 32 columns 256
// steps a tile (two m64 tiles a consumer warpgroup), else 128.
template <int BN>
struct WgChoice {
  using Tile = WgTile<BN, BN <= 16 ? 2 : 1, 8, 4>;
};

// The f32 core's steps a tile for a product of cols columns.
int wg_tile_m(int cols) {
  switch (wg_tile_n(cols)) {
    case 8: return WgChoice<8>::Tile::BM;
    case 16: return WgChoice<16>::Tile::BM;
    case 32: return WgChoice<32>::Tile::BM;
    case 64: return WgChoice<64>::Tile::BM;
    default: return WgChoice<128>::Tile::BM;
  }
}

// The product's B for the f32 core at tile width BN: the weights of the
// product W(n, c, tap) = w[(n * kdim + c) * 3 + tap], or with transw (dx:
// n a layer input channel, c a layer output channel) w[(c * cols + n) * 3
// + 2 - tap], zero outside (cols, kdim), split v = big + small (TF32) and
// arranged stage by stage: the image of column tile nb and stage ks starts
// at ws + (nb * nks + ks) * 6 * BN * kWgBC, big plane then small, each
// tap's BN x kWgBC block in core matrices.  One thread per (stage, tap,
// n, c).
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_weight_split_kernel(const float* __restrict__ w, float* __restrict__ ws, int kdim, int cols,
                         int transw, int nks, long long count) {
  constexpr int kBlock = BN * kWgBC;  // one tap of one plane
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const int j = (int)(i % kBlock), tap = (int)(i / kBlock % 3);
  const long long stage = i / (3 * kBlock);
  const int nb = (int)(stage / nks), ks = (int)(stage % nks);
  const int n = nb * BN + j / 64 * 8 + j % 32 / 4;
  const int c = ks * kWgBC + j % 64 / 32 * 4 + j % 4;
  float v = 0.f;
  if (n < cols && c < kdim)
    v = transw ? w[((size_t)c * cols + n) * 3 + 2 - tap] : w[((size_t)n * kdim + c) * 3 + tap];
  unsigned big, small;
  split_tf32(v, big, small);
  float* img = ws + stage * 6 * kBlock + tap * kBlock + j;
  img[0] = __uint_as_float(big);
  img[3 * kBlock] = __uint_as_float(small);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Waits for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// An arrival that also expects bytes from the TMA unit.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// An arrival once the thread's cp.async copies so far have landed.
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// A bulk copy of bytes (a multiple of 16, both ends 16-byte aligned) by
// the TMA unit, completing on bar.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The shared-memory descriptor of one tap's B (BN x 8 channels) at addr:
// K-major core matrices with no swizzle, 128 bytes from one 4-channel half
// to the next (the leading offset) and 256 from 8 columns to the next (the
// stride offset).
__device__ __forceinline__ uint64_t wg_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of v above a wg_wait.
__device__ __forceinline__ void wg_hold(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// d (+)= a (64 x 8, TF32 fragments in registers) * b (8 x N at the
// descriptor b), f32 accumulate; scale_d 0 discards d first.  d[4j + e]
// is row g (+ 8 for e >= 2) and column 8j + 2q + (e & 1) of the warp's 16
// rows, g = lane / 4, q = lane % 4; a[0..3] are the fragment's (g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4).
template <int N>
struct Wgmma;
template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], const unsigned (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], const unsigned (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const unsigned (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const unsigned (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const unsigned (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// out[s, col, t] = (bias[col] if bias) + the product's (t, col) entry,
// relu'd where relu, in f32, for the product over src (n, kdim, len) and
// the split weights ws (conv_weight_split_kernel's), with cols columns.
// Tiles: (step tile, column tile, sample), ntt x ntn x n of them, the step
// tile fastest; block b takes tiles b, b + gridDim.x, ...  pairs: len
// even and src 8-byte aligned (8-byte copies of x).
template <typename Tile>
__global__ void __launch_bounds__(Tile::kThreads, 1)
conv_mma_kernel(const float* __restrict__ src, const float* __restrict__ ws,
                const float* __restrict__ bias, float* __restrict__ out, int kdim, int cols,
                int len, int ntt, int ntn, int n, int use_relu, int pairs) {
  extern __shared__ __align__(128) float wg_smem[];
  constexpr int S = Tile::STAGES, BN = Tile::BN, BM = Tile::BM, BC = Tile::BC;
  constexpr int MW = Tile::MW, kLdX = Tile::kLdX, R = BN / 2;
  const unsigned full0 = smem_addr(wg_smem + S * Tile::kStage), empty0 = full0 + 8 * S;
  const int nks = (kdim + BC - 1) / BC;
  const long long tiles = (long long)ntt * ntn * n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 32 * Tile::PW + 1);  // the producers' copies, the bulk copy
      mbar_init(empty0 + 8 * s, 4 * kWgConsumers);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int stage = 0;
  unsigned phase = 0;

  if (warp >= 4 * kWgConsumers) {  // a producer: its share of x, and the first one the weights
    const int pw = warp - 4 * kWgConsumers;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int t0 = (int)(tile % ntt) * BM, nb = (int)(tile / ntt % ntn);
      const float* xg = src + (size_t)(tile / ((long long)ntt * ntn)) * kdim * len;
      for (int ks = 0; ks < nks; ++ks) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        float* st = wg_smem + stage * Tile::kStage;
        const unsigned full = full0 + 8 * stage;
        if (pw == 0 && lane == 0) {
          mbar_expect_tx(full, Tile::kWFloats * 4);
          bulk_load(smem_addr(st), ws + ((size_t)nb * nks + ks) * Tile::kWFloats,
                    Tile::kWFloats * 4, full);
        }
        float* xs = st + Tile::kWFloats;
        const int c0 = ks * BC;
        if (pairs) {  // each pair wholly inside or outside [0, T): t0 and T even
          constexpr int kRow = Tile::kXCols / 2;
          for (int e = pw * 32 + lane; e < BC * kRow; e += 32 * Tile::PW) {
            const int ci = e / kRow, j = (e - ci * kRow) * 2, t = t0 - 2 + j;
            const bool in = c0 + ci < kdim && t >= 0 && t < len;
            cp_async8(xs + ci * kLdX + j, in ? xg + (size_t)(c0 + ci) * len + t : src, in);
          }
        } else {
          constexpr int kRow = Tile::kXCols;
          for (int e = pw * 32 + lane; e < BC * kRow; e += 32 * Tile::PW) {
            const int ci = e / kRow, j = e - ci * kRow, t = t0 - 2 + j;
            const bool in = c0 + ci < kdim && t >= 0 && t < len;
            cp_async4(xs + ci * kLdX + j, in ? xg + (size_t)(c0 + ci) * len + t : src, in);
          }
        }
        cp_async_arrive(full);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // every stage released before the warp leaves
    for (int i = 0; i < S; ++i) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // a consumer: warp wq of warpgroup wg holds the rows wq * 16 .. of its
  // MW m64 tiles, steps wg * 64 * MW + mi * 64 + ..
  const int g = lane >> 2, q = lane & 3;
  const int row = (warp >> 2) * 64 * MW + (warp & 3) * 16 + g;  // the first tile's first step
  float acc[MW][R], sl[MW][R];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int i = 0; i < R; ++i) sl[mi][i] = 0.f;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = (int)(tile % ntt) * BM, nb = (int)(tile / ntt % ntn);
    const size_t s = (size_t)(tile / ((long long)ntt * ntn));
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[mi][i] = 0.f;
    for (int ks = 0; ks < nks; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      const float* st = wg_smem + stage * Tile::kStage;
      // column j of the slab is step t0 - 2 + j: tap k of step t0 + r reads r + k + 1
      const float* xr = st + Tile::kWFloats + q * kLdX + row + 1;
      unsigned ab[MW][3][4], as[MW][3][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float* r = xr + mi * 64 + k;
          split_tf32(r[0], ab[mi][k][0], as[mi][k][0]);
          split_tf32(r[8], ab[mi][k][1], as[mi][k][1]);
          split_tf32(r[4 * kLdX], ab[mi][k][2], as[mi][k][2]);
          split_tf32(r[4 * kLdX + 8], ab[mi][k][3], as[mi][k][3]);
        }
      const unsigned wb = smem_addr(st);
      wg_fence();
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint64_t big = wg_desc(wb + k * BN * BC * 4);
        const uint64_t small = wg_desc(wb + (Tile::kPlane + k * BN * BC) * 4);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          Wgmma<BN>::mma(sl[mi], as[mi][k], big, k > 0);  // the stage's sums start at 0
          Wgmma<BN>::mma(sl[mi], ab[mi][k], small, 1);
          Wgmma<BN>::mma(sl[mi], ab[mi][k], big, 1);
        }
      }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int i = 0; i < R; ++i) wg_hold(sl[mi][i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage is free
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[mi][i] += sl[mi][i];
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    float* outs = out + s * cols * len;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nb * BN + 8 * j + 2 * q + e;
        if (col >= cols) continue;
        const float bc = bias != nullptr ? bias[col] : 0.f;
        float* o = outs + (size_t)col * len + t0 + row;
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = acc[mi][4 * j + 2 * h + e] + bc;
            if (use_relu) v = relu(v);
            if (t0 + row + 64 * mi + 8 * h < len) o[64 * mi + 8 * h] = v;
          }
      }
    }
  }
}

// ---- dw's f32 stage 1 on the warpgroup MMA ----
//
// (The note above the dw pass says why and what was timed.)  The product
// dw[o, i, k] = sum_t dc[o, t] * x[i, t + k - 1] on wgmma m64n64k8 (TF32,
// K = steps): A = x at the tap's shift, from registers (M = 64 input
// channels), B = dc's big and small planes in shared memory (N = 64 output
// channels); three consumer warpgroups, one a tap, share each stage's dc.
//
// The TMA unit copies a stage's 64 rows of x and of dc as 2-D boxes of a
// tensor map.  A map's row stride must be a multiple of 16 bytes, which T
// = 750 or 746 steps (3000, 2984 bytes) is not, so where T = 2 (mod 4)
// the map's rows are row pairs (2 T steps, the even row then the odd) and
// a stage takes two boxes a tensor, the even rows and the odd rows; T = 0
// (mod 4) takes one box of plain rows (fold 1 row a map row, or 2).  A
// box must also start at a multiple of 4 steps of its map row, so x's box
// starts at t0 - 4, and an odd row's boxes 2 steps early.  A box reads
// zeros outside the map, but a paired row's neighbour inside it: the
// producers zero those values of x (at a sample's first and last steps)
// and mask dc's past T.  Where a map cannot serve (T odd, an odd channel
// count with fold 2, tensors not 16-byte aligned) the rows go by cp.async,
// zero-filled, in the fold 1 layout.

// The tiling of the f32 dw stage (conv3.py: DW_WG_TILE_O, DW_WG_TILE_C):
// 64 output channels x 64 input channels (x 3 taps) a tile, 3 stages of
// 64 steps filled by 4 producer warps, each stage's products issued in
// two batches of 4 k8 steps (the A fragments of a batch live in registers
// until its wgmma complete), 136 registers a consumer thread by setmaxnreg
// (the producers keep the rest).  A stage holds B's big and small planes
// (kPlane floats each; k8 step kb's 64 x 8 block at kb * 512, in wgmma's
// K-major core matrices: element (n, c) at (n / 8) * 64 + (c / 4) * 32 +
// (n % 8) * 4 + c % 4), then x (64 rows of kXCols floats: steps t0 - 4 +
// j, an odd row of fold 2 t0 - 2 + j) and dc (64 rows of kDCols: steps t0
// + j, an odd row of fold 2 t0 - 2 + j), each as fold boxes of 64 / fold
// rows (row r in box r % fold).  kXCols = 12 (mod 32) puts an A
// fragment's 32 lanes on 32 banks: with fold 2 the fragment's rows g (+
// 8) hold the even (odd) input channels, one box each.  Every box starts
// at a 128-byte boundary.
struct DwWgTile {
  static constexpr int BK = 64, STAGES = 3;
  static constexpr int NC = 3, PW = 4;  // consumer warpgroups (a tap each), producer warps
  static constexpr int kThreads = 128 * NC + 32 * PW;
  static constexpr int BO = 64, BI = 64, BN = 64;  // output, input channels; B's columns
  static constexpr int kKB = BK / 8;               // k8 steps a stage
  static constexpr int kKC = 4;                    // k8 steps a batch of wgmma
  // registers a consumer thread takes by setmaxnreg, and a producer thread
  // keeps (the rest of the 65,536)
  static constexpr int kRegs = 136;
  static constexpr int kProducerRegs = (65536 - 128 * NC * kRegs) / (32 * PW) / 8 * 8;
  static constexpr int kXCols = BK + 12, kDCols = BK + 4;
  static constexpr int kPlane = BK * BN;
  static constexpr int kX = 2 * kPlane, kDc = kX + BI * kXCols;  // x's and dc's offsets
  static constexpr int kStage = kDc + BO * kDCols;
  static constexpr int kSmemBytes = (int)sizeof(float) * STAGES * kStage + 24 * STAGES;
  static_assert(kKB % kKC == 0 && kXCols % 32 == 12 && (kStage * 4) % 128 == 0 &&
                    (kX * 4) % 128 == 0 && (kDc * 4) % 128 == 0 &&
                    (BI / 2 * kXCols * 4) % 128 == 0 && (BO / 2 * kDCols * 4) % 128 == 0 &&
                    kSmemBytes <= 232448 && kRegs % 8 == 0 && kProducerRegs >= 24,
                "DwWgTile: bad shape");
};

// A 2-D box copy of the tensor map at tmap, (column c0, map row c1) on,
// by the TMA unit into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const void* tmap, int c0, int c1,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Producer thread p's cp.async share of one stage's rows r0 + r (r < 64)
// of sample s: x (X; steps t0 - 4 + j, j < kXCols) or dc (steps t0 + j, j
// < kDCols), zero outside the tensor, in the fold 1 layout.  PAIRS: 8-byte
// copies (T even, both tensors 8-byte aligned; t0 is even).
template <typename Tile, bool X, bool PAIRS>
__device__ __forceinline__ void dw_wg_fill(float* dst, const float* __restrict__ src, int s,
                                           int r0, int nrows, int t0, int len, int p) {
  constexpr int W = PAIRS ? 2 : 1, kCols = X ? Tile::kXCols : Tile::kDCols, kRow = kCols / W;
  const float* base = src + (size_t)s * nrows * len;
  for (int e = p; e < 64 * kRow; e += 32 * Tile::PW) {
    const int r = e / kRow, j = (e - r * kRow) * W, t = (X ? t0 - 4 : t0) + j;
    const bool in = r0 + r < nrows && t >= 0 && t < len;
    const float* g = in ? base + (size_t)(r0 + r) * len + t : src;
    if constexpr (PAIRS)
      cp_async8(dst + r * kCols + j, g, in);
    else
      cp_async4(dst + r * kCols + j, g, in);
  }
}

// The stage at st once its copies have landed, producer thread p's share:
// with fold 2, x's values that a paired row's neighbour filled (the odd
// rows' steps before 0, the even rows' from T on) set to 0; then B's
// planes from dc: row n's 4 values at steps t0 + c .. t0 + c + 3 (0 from
// T on), split v = big + small.  A warp takes 32 rows at one c, thread j
// of each 8 consecutive threads row 8 nb + j: its loads hit distinct banks
// (dc's rows of kDCols = 4 (mod 32) floats; with fold 2 the even and the
// odd rows 2 floats apart), and its stores fill one core matrix's 128
// bytes.
template <typename Tile>
__device__ __forceinline__ void dw_wg_expand(float* st, int t0, int len, int fold, int p) {
  constexpr int BK = Tile::BK, BN = Tile::BN, kXCols = Tile::kXCols, kDCols = Tile::kDCols;
  constexpr int kNp = 32 * Tile::PW;
  static_assert(BN * BK / 4 % kNp == 0, "dw_wg_expand: ragged share");
  if (fold == 2) {
    float* xs = st + Tile::kX;
    if (t0 == 0)  // the odd rows' steps -2 and -1 (columns 0 and 1)
      for (int e = p; e < Tile::BI; e += kNp) xs[(Tile::BI / 2 + e / 2) * kXCols + e % 2] = 0.f;
    const int j0 = len - t0 + 4, nj = kXCols - j0;  // the even rows' columns from step T on
    for (int e = p; e < Tile::BI / 2 * nj; e += kNp) xs[e / nj * kXCols + j0 + e % nj] = 0.f;
  }
  const float* dcs = st + Tile::kDc;
  const bool tail = t0 + BK > len;  // steps from T on: 0
#pragma unroll
  for (int k = 0; k < BN * BK / 4 / kNp; ++k) {
    const int e = p + k * kNp;
    const int j = e & 7, nb = (e >> 3) % (BN / 8), cg = (e >> 3) / (BN / 8);
    const int n = nb * 8 + j, c = cg * 4, kb = cg / 2, h = cg % 2;
    float v[4];
    if (fold == 2) {  // an odd row starts 2 steps early
      const int b = n % 2;
      const float* r = dcs + b * (BN / 2) * kDCols + n / 2 * kDCols + c + 2 * b;
      const float2 r01 = *reinterpret_cast<const float2*>(r);
      const float2 r23 = *reinterpret_cast<const float2*>(r + 2);
      v[0] = r01.x, v[1] = r01.y, v[2] = r23.x, v[3] = r23.y;
    } else {
      const float4 r = *reinterpret_cast<const float4*>(dcs + n * kDCols + c);
      v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
    }
    unsigned big[4], small[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) split_tf32(tail && t0 + c + u >= len ? 0.f : v[u], big[u], small[u]);
    float* dst = st + kb * BN * 8 + nb * 64 + h * 32 + j * 4;
    *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]),
                                                  __uint_as_float(big[2]), __uint_as_float(big[3]));
    *reinterpret_cast<float4*>(dst + Tile::kPlane) =
        make_float4(__uint_as_float(small[0]), __uint_as_float(small[1]),
                    __uint_as_float(small[2]), __uint_as_float(small[3]));
  }
}

// The tiles of the f32 dw stage for cin input and cout output channels.
template <typename Tile>
__host__ __device__ int dw_wg_tiles(int cin, int cout) {
  return (cout + Tile::BO - 1) / Tile::BO * ((cin + Tile::BI - 1) / Tile::BI);
}

// A block's walk over its items (tile, split) and each item's (sample,
// slice) pairs, in order: the fills of its stages.
struct DwWalk {
  int item, qi, nq, s0, o0, i0, z;
};

template <typename Tile>
__device__ __forceinline__ void dw_walk_item(DwWalk& w, int n, int cin, int cout, int nsplit,
                                             int slices) {
  const int tiles = dw_wg_tiles<Tile>(cin, cout), nto = (cout + Tile::BO - 1) / Tile::BO;
  for (; w.item < tiles * nsplit; w.item += gridDim.x) {
    w.z = w.item / tiles;
    const int tile = w.item - w.z * tiles;
    w.o0 = tile % nto * Tile::BO, w.i0 = tile / nto * Tile::BI;
    w.s0 = (int)((long long)n * w.z / nsplit);
    w.nq = ((int)((long long)n * (w.z + 1) / nsplit) - w.s0) * slices;
    w.qi = 0;
    if (w.nq > 0) return;
  }
}

// Stage 1, f32 on the warpgroup MMA: part[z][o][i * 3 + k] over the samples
// of split z.  Items (tile, split), the output-channel tile fastest, then
// the input-channel tile, then the split; block b takes items b, b +
// gridDim.x, ...  Each item walks its (sample, slice) pairs in order
// through the ring; each stage's products (BK steps) sum from zero in the
// tensor cores and are added to the item's sums in f32 outside them.
// fold: 1 or 2, the tensor maps tx and tdc serve (rows of fold T steps);
// 0, they do not, and the rows go by cp.async (pairs: 8-byte copies).  A
// stage goes through three mbarriers: landed (the copies: every producer
// thread arrives, the first with the TMA unit's bytes), full (x patched
// and the planes made: every producer thread) and empty (every consumer
// warp).
template <typename Tile>
__global__ void __launch_bounds__(Tile::kThreads, 1)
dw_mma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdc,
              const float* __restrict__ dc, const float* __restrict__ x, float* __restrict__ part,
              int n, int cin, int cout, int len, int nsplit, int fold, int pairs) {
  extern __shared__ __align__(128) float dwg_smem[];
  constexpr int S = Tile::STAGES, BK = Tile::BK, KB = Tile::kKB, KC = Tile::kKC;
  constexpr int BN = Tile::BN, R = BN / 2, kXCols = Tile::kXCols;
  // the producers keep kLag stages of copies in flight and finish the
  // oldest; two stages stay full ahead of the consumers
  constexpr int kLag = S - 2;
  const unsigned full0 = smem_addr(dwg_smem + S * Tile::kStage), empty0 = full0 + 8 * S;
  const unsigned landed0 = empty0 + 8 * S;
  const int slices = (len + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 32 * Tile::PW);
      mbar_init(empty0 + 8 * s, 4 * Tile::NC);
      mbar_init(landed0 + 8 * s, 32 * Tile::PW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xf = fold == 2 ? 2 : 1;  // the smem layout's rows a box
  int stage = 0;
  unsigned phase = 0;

  if (warp >= 4 * Tile::NC) {  // a producer: its share of each stage's copies, then of the rest
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Tile::kProducerRegs));
    const int p = threadIdx.x - 128 * Tile::NC;
    DwWalk f{(int)blockIdx.x}, g{(int)blockIdx.x};  // the next fill, and the next to finish
    dw_walk_item<Tile>(f, n, cin, cout, nsplit, slices);
    dw_walk_item<Tile>(g, n, cin, cout, nsplit, slices);
    // finish the fill g in ring slot at, its landed phase par
    const auto finish = [&](int at, unsigned par) {
      mbar_wait(landed0 + 8 * at, par);
      dw_wg_expand<Tile>(dwg_smem + at * Tile::kStage, g.qi % slices * BK, len, fold, p);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full0 + 8 * at);
      if (++g.qi == g.nq) {
        g.item += gridDim.x;
        dw_walk_item<Tile>(g, n, cin, cout, nsplit, slices);
      }
    };
    int filled = 0;  // stages filled; the last kLag of them not yet finished
    while (f.item < dw_wg_tiles<Tile>(cin, cout) * nsplit) {
      const int s = f.s0 + f.qi / slices, t0 = f.qi % slices * BK;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      float* st = dwg_smem + stage * Tile::kStage;
      const unsigned landed = landed0 + 8 * stage;
      if (fold != 0) {
        if (p == 0) {
          mbar_expect_tx(landed, 4 * (Tile::BI * kXCols + Tile::BO * Tile::kDCols));
          for (int b = 0; b < fold; ++b) {  // b: the odd rows' box
            tma_load_2d(smem_addr(st + Tile::kX + b * (Tile::BI / 2) * kXCols), &tx,
                        t0 - 4 + b * (len + 2), (s * cin + f.i0) / fold, landed);
            tma_load_2d(smem_addr(st + Tile::kDc + b * (Tile::BO / 2) * Tile::kDCols), &tdc,
                        b * (len - 2) + t0, (s * cout + f.o0) / fold, landed);
          }
        } else {
          mbar_arrive(landed);
        }
      } else {
        if (pairs) {
          dw_wg_fill<Tile, true, true>(st + Tile::kX, x, s, f.i0, cin, t0, len, p);
          dw_wg_fill<Tile, false, true>(st + Tile::kDc, dc, s, f.o0, cout, t0, len, p);
        } else {
          dw_wg_fill<Tile, true, false>(st + Tile::kX, x, s, f.i0, cin, t0, len, p);
          dw_wg_fill<Tile, false, false>(st + Tile::kDc, dc, s, f.o0, cout, t0, len, p);
        }
        cp_async_arrive(landed);
      }
      if (++filled > kLag) finish((stage + S - kLag) % S, stage >= kLag ? phase : phase ^ 1);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
      if (++f.qi == f.nq) {
        f.item += gridDim.x;
        dw_walk_item<Tile>(f, n, cin, cout, nsplit, slices);
      }
    }
    for (int r = filled < kLag ? filled : kLag; r > 0; --r)
      finish((stage + S - r) % S, stage >= r ? phase : phase ^ 1);
    // every stage released before the warp leaves
    for (int i = 0; i < S; ++i) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Tile::kRegs));
  // a consumer: warp wq = warp % 4 of warpgroup wg (tap wg) holds 16 input
  // channels of its m64 tile, i0 + wq * 16 on: its fragments' rows g and g
  // + 8 are the channels g and g + 8 of them, with fold 2 the channels 2g
  // and 2g + 1 (the even and the odd rows' boxes).  Tap wg of step t0 + c
  // reads x's column c + wg + 3 of a row (of an odd row of fold 2, c + wg +
  // 1).
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3, wq = warp & 3;
  const float* const x0 = dwg_smem + Tile::kX + wg + q;
  const int a_lo = xf == 2 ? (wq * 8 + g) * kXCols + 3
                           : (wq * 16 + g) * kXCols + 3;  // row g's offset from x0
  const int a_hi = xf == 2 ? (Tile::BI / 2 + wq * 8 + g) * kXCols + 1
                           : (wq * 16 + g + 8) * kXCols + 3;  // row g + 8's
  const int ch_lo = xf == 2 ? wq * 16 + 2 * g : wq * 16 + g;  // their channels in the tile
  const int ch_hi = xf == 2 ? ch_lo + 1 : ch_lo + 8;
  float acc[R], sl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) sl[i] = 0.f;
  DwWalk w{(int)blockIdx.x};
  for (dw_walk_item<Tile>(w, n, cin, cout, nsplit, slices);
       w.item < dw_wg_tiles<Tile>(cin, cout) * nsplit;) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int qi = 0; qi < w.nq; ++qi) {
      mbar_wait(full0 + 8 * stage, phase);
      const unsigned wb = smem_addr(dwg_smem + stage * Tile::kStage);
      const float* lo = x0 + stage * Tile::kStage + a_lo;
      const float* hi = x0 + stage * Tile::kStage + a_hi;
#pragma unroll
      for (int k0 = 0; k0 < KB; k0 += KC) {  // a batch of KC k8 steps
        unsigned ab[KC][4], as[KC][4];
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const int c = (k0 + kc) * 8;
          split_tf32(lo[c], ab[kc][0], as[kc][0]);
          split_tf32(hi[c], ab[kc][1], as[kc][1]);
          split_tf32(lo[c + 4], ab[kc][2], as[kc][2]);
          split_tf32(hi[c + 4], ab[kc][3], as[kc][3]);
        }
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const int kb = k0 + kc;
          const uint64_t big = wg_desc(wb + kb * BN * 8 * 4);
          const uint64_t small = wg_desc(wb + (Tile::kPlane + kb * BN * 8) * 4);
          Wgmma<BN>::mma(sl, as[kc], big, kb > 0);  // the stage's sums start at 0
          Wgmma<BN>::mma(sl, ab[kc], small, 1);
          Wgmma<BN>::mma(sl, ab[kc], big, 1);
        }
        wg_commit();
        wg_wait();
#pragma unroll
        for (int i = 0; i < R; ++i) wg_hold(sl[i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage is free
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += sl[i];
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    // d[4j + e]: fragment row g (+ 8 for e >= 2), output channel o0 + 8j +
    // 2q + (e & 1)
    const int ncols = 3 * cin;
    float* pz = part + (size_t)w.z * cout * ncols;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = w.i0 + (e >> 1 ? ch_hi : ch_lo), o = w.o0 + 8 * j + 2 * q + (e & 1);
        if (i < cin && o < cout) pz[(size_t)o * ncols + i * 3 + wg] = acc[4 * j + e];
      }
    w.item += gridDim.x;
    dw_walk_item<Tile>(w, n, cin, cout, nsplit, slices);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda): null if the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of an f32 (rows, len) tensor at src as rows of fold * len steps,
// boxes of cols steps x 64 / fold rows; false if it cannot be made.
bool dw_tensor_map(CUtensorMap* map, const float* src, long long rows, int len, int fold,
                   int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)fold * len, (cuuint64_t)(rows / fold)};
  const cuuint64_t stride[1] = {(cuuint64_t)fold * len * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)(64 / fold)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(src), dims, stride,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets the kernel K take smem bytes of dynamic shared memory (past 48 KB)
// on the current device; the attribute is set on a device's first call
// only, which keeps the host call off the launch path (and out of a CUDA
// graph's capture).  Devices past the 64th set it on every call.
template <auto K>
cudaError_t allow_smem(int smem) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (err != cudaSuccess || (done.load(std::memory_order_relaxed) & bit) != 0) return err;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// Stage 1 of dw in f32 on the warpgroup MMA with the tiling Tile: a
// persistent grid of at most kWgBlocks blocks over the tiles x nsplit
// items, the rows copied by the TMA unit where the tensor maps serve
// (counted in dw_copy_launches).
template <typename Tile>
cudaError_t launch_dw_wgmma(const float* dc, const float* x, float* part, int n, int cin,
                            int cout, int len, int nsplit, cudaStream_t stream) {
  using Kernel = void (*)(CUtensorMap, CUtensorMap, const float*, const float*, float*, int, int,
                          int, int, int, int, int);
  constexpr Kernel kernel = dw_mma_kernel<Tile>;
  const long long items = (long long)dw_wg_tiles<Tile>(cin, cout) * nsplit;
  const uintptr_t a = reinterpret_cast<uintptr_t>(dc) | reinterpret_cast<uintptr_t>(x);
  const int pairs = len % 2 == 0 && a % 8 == 0;
  int fold = len % 4 == 0 ? 1 : 2;
  if (len % 2 != 0 || a % 16 != 0 || (fold == 2 && (cin % 2 != 0 || cout % 2 != 0)) ||
      (long long)n * (cin > cout ? cin : cout) >= (1LL << 31))
    fold = 0;
  CUtensorMap tx{}, tdc{};
  DwCopy copy = fold != 0 ? kDwCopyTma : kDwCopyRows;
  if (fold != 0 && !(dw_tensor_map(&tx, x, (long long)n * cin, len, fold, Tile::kXCols) &&
                     dw_tensor_map(&tdc, dc, (long long)n * cout, len, fold, Tile::kDCols)))
    fold = 0, copy = kDwCopyNoMap;
  const cudaError_t e = allow_smem<kernel>(Tile::kSmemBytes);
  if (e != cudaSuccess) return e;
  kernel<<<(int)(items < kWgBlocks ? items : kWgBlocks), Tile::kThreads, Tile::kSmemBytes,
           stream>>>(tx, tdc, dc, x, part, n, cin, cout, len, nsplit, fold, pairs);
  dw_copy_launches[copy].fetch_add(1, std::memory_order_relaxed);
  return cudaGetLastError();
}

// ---- bf16: mma.sync ----

// The bf16 core's tiling (conv3.py: MMA_TILE_M, MMA_TILE_N): a block of
// kThreads owns BM rows (output channels; dx: input channels) x BN steps
// of one sample, 8 warps of 32 rows x 32 steps (2 x 4 m16n8 tiles), and
// walks K in slices of BC = 16 channels x 3 taps through a 3-stage ring
// (72 KB: two blocks an SM).  A stage holds A[tap][m][ci] = W(m0 + m,
// c0 + ci, tap) in rows of kLdA floats and X[ci][j] = source channel
// c0 + ci at step t0 - 2 + j (zero outside [0, T)) in rows of kLdX floats.
// The fragments read A as pairs at (g, 2q) and X at (2q, g): kLdA = 8 (mod
// 32) and kLdX = 4 (mod 16).  The slab starts 2 steps early so 8-byte
// copies stay aligned where T is even.
struct MmaTile {
  static constexpr int BM = 64, BN = 128, BC = 16, STAGES = 3, WM = 2;
  static constexpr int WN = kWarps / WM;    // warps along the steps
  static constexpr int kMI = BM / WM / 16;  // m16 tiles per warp
  static constexpr int kNI = BN / WN / 8;   // n8 tiles per warp
  static constexpr int kLdA = BC + 8;
  static constexpr int kLdX = BN + 4;
  static constexpr int kXCols = BN + 4;  // filled columns: steps t0 - 2 .. t0 + BN + 1
  static constexpr int kAFloats = 3 * BM * kLdA;
  static constexpr int kStage = kAFloats + BC * kLdX;
  static constexpr int kSmemBytes = (int)sizeof(float) * STAGES * kStage;
  static_assert(kXCols <= kLdX && kMI >= 1 && kNI >= 1 && BC == 16, "MmaTile: bad shape");
};

// Stage K slice (channels c0 ..) for the block's rows m0 .. and steps
// t0 .. of one sample: src is the sample's (kdim, len) source rows (x, or
// dc for dx), W(m, i, tap) is w[(m * kdim + i) * 3 + tap], or with TRANSW
// (dx: m is a layer input channel, i a layer output channel)
// w[(i * mdim + m) * 3 + 2 - tap].  The weights and a bf16 source are
// converted on their way in with plain loads; an f32 source (dc) goes in
// by cp.async (8-byte copies with PAIRS: T even, src 8-byte aligned, each
// pair wholly inside or outside [0, T) as t0 is even).
template <typename TB, bool TRANSW, bool PAIRS>
__device__ __forceinline__ void conv_fill(float* st, const TB* __restrict__ src,
                                          const __nv_bfloat16* __restrict__ w, int c0, int m0,
                                          int t0, int kdim, int mdim, int len) {
  constexpr int BM = MmaTile::BM, BC = MmaTile::BC, kLdA = MmaTile::kLdA;
  constexpr int kLdX = MmaTile::kLdX;
#pragma unroll 4
  for (int e = threadIdx.x; e < BM * BC * 3; e += kThreads) {
    // consecutive e read consecutive weights
    int m, ci, k;
    if constexpr (TRANSW) {
      ci = e / (BM * 3);
      const int r = e - ci * (BM * 3);
      m = r / 3;
      k = r - m * 3;
    } else {
      m = e / (BC * 3);
      const int r = e - m * (BC * 3);
      ci = r / 3;
      k = r - ci * 3;
    }
    const bool in = m0 + m < mdim && c0 + ci < kdim;
    const size_t gi = TRANSW ? ((size_t)(c0 + ci) * mdim + m0 + m) * 3 + k
                             : ((size_t)(m0 + m) * kdim + c0 + ci) * 3 + k;
    st[((TRANSW ? 2 - k : k) * BM + m) * kLdA + ci] = in ? to_f32(w[gi]) : 0.f;
  }
  constexpr int W = PAIRS ? 2 : 1;
  constexpr int kRow = MmaTile::kXCols / W;
  float* xs = st + MmaTile::kAFloats;
#pragma unroll 2
  for (int e = threadIdx.x; e < BC * kRow; e += kThreads) {
    const int ci = e / kRow, j = (e - ci * kRow) * W;
    const int t = t0 - 2 + j;
    const bool in = c0 + ci < kdim && t >= 0 && t < len;
    const TB* p = in ? src + (size_t)(c0 + ci) * len + t : src;
    float* dst = xs + ci * kLdX + j;
    if constexpr (!std::is_same<TB, float>::value) {
      dst[0] = in ? to_f32(p[0]) : 0.f;
      if constexpr (PAIRS) dst[1] = in ? to_f32(p[1]) : 0.f;
    } else if constexpr (PAIRS) {
      cp_async8(dst, p, in);
    } else {
      cp_async4(dst, p, in);
    }
  }
}

// acc[mi][ni] += the warp's share of the staged slice at st: rows
// (wr * kMI + mi) * 16 .., steps (wc * kNI + ni) * 8 .., over the slice's
// 16 channels x 3 taps, one m16n8k16 step a tap.  g = lane / 4 and q =
// lane % 4 index the fragments as the PTX ISA lays them out.
__device__ __forceinline__ void conv_mma_slice(const float* st, int wr, int wc, int g, int q,
                                               float (&acc)[MmaTile::kMI][MmaTile::kNI][4]) {
  constexpr int kLdA = MmaTile::kLdA, kLdX = MmaTile::kLdX, kMI = MmaTile::kMI;
  constexpr int kNI = MmaTile::kNI, kTap = MmaTile::BM * kLdA;  // A's stride between taps
  const float* A = st + (wr * kMI * 16 + g) * kLdA;
  // column j of the slab is step t0 - 2 + j: tap k of step t0 + s reads s + k + 1
  const float* X = st + MmaTile::kAFloats + wc * kNI * 8 + g + 1;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    unsigned a[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const float* r = A + tap * kTap + mi * 16 * kLdA + 2 * q;
      const float2 r0 = *reinterpret_cast<const float2*>(r);
      const float2 r1 = *reinterpret_cast<const float2*>(r + 8 * kLdA);
      const float2 r2 = *reinterpret_cast<const float2*>(r + 8);
      const float2 r3 = *reinterpret_cast<const float2*>(r + 8 * kLdA + 8);
      a[mi][0] = pack_bf16(r0.x, r0.y);
      a[mi][1] = pack_bf16(r1.x, r1.y);
      a[mi][2] = pack_bf16(r2.x, r2.y);
      a[mi][3] = pack_bf16(r3.x, r3.y);
    }
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni) {
      const float* xr = X + 2 * q * kLdX + ni * 8 + tap;
      const unsigned b0 = pack_bf16(xr[0], xr[kLdX]);
      const unsigned b1 = pack_bf16(xr[8 * kLdX], xr[9 * kLdX]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
    }
  }
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// out[n, m, t] = (bias[m] if bias) + the product's (m, t) entry, relu'd with
// RELU, in TOUT.  One block per (BN steps, BM rows, sample), walking the K
// slices through the cp.async ring.  PAIRS also means out is 2-element
// aligned, so the stores go in pairs.
template <typename Tile, typename T, typename TB, typename TOUT, bool TRANSW, bool RELU, bool PAIRS>
__global__ void __launch_bounds__(kThreads, 2)
conv_mma_kernel(const TB* __restrict__ src, const T* __restrict__ w, const T* __restrict__ bias,
                TOUT* __restrict__ out, int kdim, int mdim, int len) {
  static_assert(std::is_same<Tile, MmaTile>::value && std::is_same<T, __nv_bfloat16>::value,
                "the mma.sync core is bf16's");
  extern __shared__ __align__(16) float conv_smem[];
  constexpr int kMI = Tile::kMI, kNI = Tile::kNI, S = Tile::STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp % Tile::WM, wc = warp / Tile::WM;
  const int t0 = blockIdx.x * Tile::BN, m0 = blockIdx.y * Tile::BM, n = blockIdx.z;
  const TB* srcn = src + (size_t)n * kdim * len;
  const int slices = (kdim + Tile::BC - 1) / Tile::BC;
  float acc[kMI][kNI][4] = {};

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < slices)
      conv_fill<TB, TRANSW, PAIRS>(conv_smem + st * Tile::kStage, srcn, w, st * Tile::BC, m0,
                                   t0, kdim, mdim, len);
    cp_async_commit();
  }
  for (int i = 0; i < slices; ++i) {
    cp_async_wait<S - 2>();  // slice i has landed
    __syncthreads();         // ... for every thread; slice i-1's stage is free
    const int next = i + S - 1;
    if (next < slices)
      conv_fill<TB, TRANSW, PAIRS>(conv_smem + next % S * Tile::kStage, srcn, w,
                                   next * Tile::BC, m0, t0, kdim, mdim, len);
    cp_async_commit();
    float sl[kMI][kNI][4] = {};
    conv_mma_slice(conv_smem + i % S * Tile::kStage, wr, wc, g, q, sl);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += sl[mi][ni][e];
  }

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
      const int m = m0 + (wr * kMI + mi) * 16 + g + 8 * h;
      if (m >= mdim) continue;
      const float bm = bias != nullptr ? to_f32(bias[m]) : 0.f;
      TOUT* row = out + ((size_t)n * mdim + m) * len;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int t = t0 + (wc * kNI + ni) * 8 + 2 * q;
        float v0 = acc[mi][ni][2 * h] + bm, v1 = acc[mi][ni][2 * h + 1] + bm;
        if (RELU) {
          v0 = relu(v0);
          v1 = relu(v1);
        }
        if (PAIRS) {
          if (t < len) store2(row + t, v0, v1);
        } else {
          if (t < len) store(row + t, v0);
          if (t + 1 < len) store(row + t + 1, v1);
        }
      }
    }
  }
}

// The forward below kConvStreamBelow output channels: out[n, o, t] =
// bias[o] + the conv, in TOUT, for o < cout <= OMAX.  One block per (64
// steps, sample); warp wi sums the input channels [cin * wi / 8,
// cin * (wi + 1) / 8) in order, each lane its two steps t, t + 1 (one
// VEC = 2 load: T even, x aligned), with t - 1 and t + 2 from the
// neighbouring lanes; the warps' sums are added in warp order.
template <typename T, typename TOUT, int OMAX, int VEC>
__global__ void __launch_bounds__(kThreads)
conv_stream_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                   TOUT* __restrict__ out, int cin, int cout, int len) {
  __shared__ float red[kWarps][OMAX][kStreamSteps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kStreamSteps, n = blockIdx.y;
  const int t = t0 + 2 * lane;
  const int c_lo = (int)((long long)cin * warp / kWarps);
  const int c_hi = (int)((long long)cin * (warp + 1) / kWarps);
  const T* xn = x + (size_t)n * cin * len;
  float acc[OMAX][2];
#pragma unroll
  for (int o = 0; o < OMAX; ++o) acc[o][0] = acc[o][1] = 0.f;
#pragma unroll 8
  for (int c = c_lo; c < c_hi; ++c) {
    const T* row = xn + (size_t)c * len;
    float v0 = 0.f, v1 = 0.f;
    if constexpr (VEC == 2) {
      if (t < len) {  // T even: t + 1 < T too
        const VecOf<T, 2> p = *reinterpret_cast<const VecOf<T, 2>*>(row + t);
        v0 = to_f32(p.v[0]);
        v1 = to_f32(p.v[1]);
      }
    } else {
      if (t < len) v0 = to_f32(row[t]);
      if (t + 1 < len) v1 = to_f32(row[t + 1]);
    }
    float left = __shfl_up_sync(0xffffffffu, v1, 1);
    float right = __shfl_down_sync(0xffffffffu, v0, 1);
    if (lane == 0) left = t0 > 0 ? to_f32(row[t0 - 1]) : 0.f;
    if (lane == 31) right = t + 2 < len ? to_f32(row[t + 2]) : 0.f;
#pragma unroll
    for (int o = 0; o < OMAX; ++o) {
      if (o < cout) {
        const T* wr = w + ((size_t)o * cin + c) * 3;
        const float w0 = to_f32(wr[0]), w1 = to_f32(wr[1]), w2 = to_f32(wr[2]);
        acc[o][0] = fmaf(w2, v1, fmaf(w1, v0, fmaf(w0, left, acc[o][0])));
        acc[o][1] = fmaf(w2, right, fmaf(w1, v1, fmaf(w0, v0, acc[o][1])));
      }
    }
  }
#pragma unroll
  for (int o = 0; o < OMAX; ++o) {
    red[warp][o][2 * lane] = acc[o][0];
    red[warp][o][2 * lane + 1] = acc[o][1];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < OMAX * kStreamSteps; e += kThreads) {
    const int o = e / kStreamSteps, j = e - o * kStreamSteps;
    if (o >= cout || t0 + j >= len) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi][o][j];
    if (bias != nullptr) v += to_f32(bias[o]);
    store(out + ((size_t)n * cout + o) * len + t0 + j, v);
  }
}

// dx below kConvStreamBelow output channels: dx[n, i, t] = sum_o (w[o, i, 0]
// * dc[n, o, t + 1] + w[o, i, 1] * dc[n, o, t] + w[o, i, 2] * dc[n, o, t - 1])
// in T, for cout <= OMAX, dc rounded to T first.  One block per (64 steps,
// sample) holds the block's steps of dc with their halo in shared memory;
// warp wi writes the input channels wi, wi + 8, ..., each lane its two
// steps t, t + 1 (one VEC = 2 store: T even, dx aligned), the output
// channels summed in order.
template <typename T, int OMAX, int VEC>
__global__ void __launch_bounds__(kThreads)
dx_stream_kernel(const float* __restrict__ dc, const T* __restrict__ w, T* __restrict__ dx,
                 int cin, int cout, int len) {
  constexpr int kCols = kStreamSteps + 2;
  __shared__ float dcs[OMAX][kCols];  // dcs[o][j] = dc[n, o, t0 - 1 + j], zero outside [0, T)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kStreamSteps, n = blockIdx.y;
  const float* dcn = dc + (size_t)n * cout * len;
  for (int e = threadIdx.x; e < OMAX * kCols; e += kThreads) {
    const int o = e / kCols, t = t0 - 1 + e % kCols;
    dcs[o][e % kCols] =
        o < cout && t >= 0 && t < len ? round_to<T>(dcn[(size_t)o * len + t]) : 0.f;
  }
  __syncthreads();
  const int t = t0 + 2 * lane;
  float d[OMAX][4];  // dc at t - 1 .. t + 2
#pragma unroll
  for (int o = 0; o < OMAX; ++o)
#pragma unroll
    for (int k = 0; k < 4; ++k) d[o][k] = dcs[o][2 * lane + k];
  T* dxn = dx + (size_t)n * cin * len;
  for (int i = warp; i < cin; i += kWarps) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int o = 0; o < OMAX; ++o) {
      if (o < cout) {
        const T* wr = w + ((size_t)o * cin + i) * 3;
        const float w0 = to_f32(wr[0]), w1 = to_f32(wr[1]), w2 = to_f32(wr[2]);
        a0 = fmaf(w0, d[o][2], fmaf(w1, d[o][1], fmaf(w2, d[o][0], a0)));
        a1 = fmaf(w0, d[o][3], fmaf(w1, d[o][2], fmaf(w2, d[o][1], a1)));
      }
    }
    T* row = dxn + (size_t)i * len;
    if constexpr (VEC == 2) {
      if (t < len) store2(row + t, a0, a1);  // T even: t + 1 < T too
    } else {
      if (t < len) store(row + t, a0);
      if (t + 1 < len) store(row + t + 1, a1);
    }
  }
}

// What row_kernel does with a row of c (f32):
//   kRowInReluFwd  y = relu((c - mean) * rsig), in T
//   kRowReluFwd    y = relu(c), in T
//   kRowInReluDc   dc = rsig * (g - mean g - xhat * mean(g * xhat)),
//                  g = dy * (xhat > 0)
//   kRowReluDc     dc = dy * (c > 0)
// with mean and rsig = rsqrt(max(E[c^2] - mean^2, 0) + eps) over T.  dc
// overwrites c, or goes to dc where that is given: then c stays, and stats
// (where given) takes each row's (mean, E[c^2] - mean^2 before the clamp),
// which the GP's second order reads to differentiate this very dc
// (conv_layer.cu: dx_vjp_row_kernel).
enum RowMode { kRowInReluFwd = 0, kRowReluFwd = 1, kRowInReluDc = 2, kRowReluDc = 3 };

// One warp per (n, o) row of c (n * cout rows of len); each lane sums its
// strided steps in order and the warp adds the lanes' sums in a fixed tree,
// so a row's statistics come out the same every run.  A row is read a few
// times, from L1 after the first.
template <typename T, int ROW>
__global__ void __launch_bounds__(kThreads)
row_kernel(float* c, const T* __restrict__ dy, T* __restrict__ y, float* dc,
           float2* __restrict__ stats, int rows, int len) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps
  float* cr = c + (size_t)r * len;
  const size_t base = (size_t)r * len;
  float* out = dc == nullptr ? cr : dc + base;
  if constexpr (ROW == kRowReluFwd) {
    for (int t = lane; t < len; t += 32) store(y + base + t, relu(cr[t]));
    return;
  }
  if constexpr (ROW == kRowReluDc) {
    for (int t = lane; t < len; t += 32) out[t] = to_f32(dy[base + t]) * step(cr[t]);
    return;
  }
  float s = 0.f, q = 0.f;
  for (int t = lane; t < len; t += 32) {
    const float v = cr[t];
    s += v;
    q += v * v;
  }
  s = warp_sum(s);
  q = warp_sum(q);
  const float mean = s / (float)len;
  float var = q / (float)len - mean * mean;
  if (stats != nullptr && lane == 0) stats[r] = make_float2(mean, var);
  var = var < 0.f ? 0.f : var;
  const float rsig = rsqrtf(var + kEps);
  if constexpr (ROW == kRowInReluFwd) {
    for (int t = lane; t < len; t += 32) store(y + base + t, relu((cr[t] - mean) * rsig));
    return;
  }
  float sg = 0.f, sgx = 0.f;
  for (int t = lane; t < len; t += 32) {
    const float xh = (cr[t] - mean) * rsig;
    const float gv = to_f32(dy[base + t]) * step(xh);
    sg += gv;
    sgx += gv * xh;
  }
  const float mg = warp_sum(sg) / (float)len;
  const float mgx = warp_sum(sgx) / (float)len;
  for (int t = lane; t < len; t += 32) {
    const float xh = (cr[t] - mean) * rsig;
    const float gv = to_f32(dy[base + t]) * step(xh);
    out[t] = rsig * ((gv - mg) - xh * mgx);
  }
}

// Rows longer than kRowPiece steps (the continuous mode's whole record:
// N = 1, T = 900,000 on an 1800-s record) take the in_relu forward's row
// pass in pieces.  row_kernel there gave the card's 132 SMs 64 blocks (one
// warp for each of 512 rows), and each lane summed 28,125 steps in order:
// its statistics moved the continuous forward 6.7x as far from float64 as
// the plain f32 path's on a 600-s record.  row_part_kernel: a block per
// (row, piece of kRowPiece steps); each thread sums its 32 steps in order,
// the block adds the threads' sums in a fixed tree, into part (s, q).
// row_sum_kernel: a warp per row adds its pieces in a fixed order (lanes
// over the pieces, then the warp's tree) into one (s, q) a row.
// row_apply_kernel: a block per (row, piece) takes its row's (s, q), so
// every block of a row takes the same mean and rsig, and normalizes its
// piece.  The partial and row sums go to the f32 scratch past c
// (conv_plan's row_parts).
//
// The time-sharded forward (a record split along time over ranks) runs the
// same three kernels in two phases, with a cross-rank sum of the row sums
// between them, and normalizes over the record's length: one rank's block
// takes the one-launch layer's kernels and bits.  c's rows are ld floats
// apart (ld = len in the one-launch path, len + 2 for a halo'd block,
// whose c is read from its column 1).
constexpr int kRowPiece = 32 * kThreads;

__global__ void __launch_bounds__(kThreads)
row_part_kernel(const float* __restrict__ c, float2* __restrict__ part, int len, int ld,
                int parts) {
  const size_t r = blockIdx.x;
  const int t0 = blockIdx.y * kRowPiece;
  const int t1 = len - t0 < kRowPiece ? len : t0 + kRowPiece;
  const float* cr = c + r * ld;
  float s = 0.f, q = 0.f;
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
    const float v = cr[t];
    s += v;
    q += v * v;
  }
  s = warp_sum(s);
  q = warp_sum(q);
  __shared__ float2 sums[kWarps];
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = make_float2(s, q);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 a = sums[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) {
      a.x += sums[i].x;
      a.y += sums[i].y;
    }
    part[r * parts + blockIdx.y] = a;
  }
}

// One warp per row: sums[r] = the row's (s, q) from its parts pieces, in
// a fixed order.
__global__ void __launch_bounds__(kThreads)
row_sum_kernel(const float2* __restrict__ part, float2* __restrict__ sums, int rows, int parts) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps
  const float2* p = part + (size_t)r * parts;
  float s = 0.f, q = 0.f;
  for (int i = lane; i < parts; i += 32) {
    const float2 v = p[i];
    s += v.x;
    q += v.y;
  }
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) sums[r] = make_float2(s, q);
}

// y = relu((c - mean) * rsig) for the row's piece, with mean = s / count
// and rsig = rsqrt(max(q / count - mean^2, 0) + eps) from the row's sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_apply_kernel(const float* __restrict__ c, int ld, const float2* __restrict__ sums,
                 T* __restrict__ y, int len, float count) {
  const size_t r = blockIdx.x;
  __shared__ float2 norm;
  if (threadIdx.x == 0) {
    const float2 a = sums[r];
    const float mean = a.x / count;
    float var = a.y / count - mean * mean;
    var = var < 0.f ? 0.f : var;
    norm = make_float2(mean, rsqrtf(var + kEps));
  }
  __syncthreads();
  const float mean = norm.x, rsig = norm.y;
  const int t0 = blockIdx.y * kRowPiece;
  const int t1 = len - t0 < kRowPiece ? len : t0 + kRowPiece;
  const float* cr = c + r * ld;
  T* yr = y + r * len;
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) store(yr + t, relu((cr[t] - mean) * rsig));
}


// ---- host launchers ---------------------------------------------------------

// The per-sample passes (the conv kernels and the row pass) put the
// samples on a grid axis of at most 65535 blocks, so the launchers walk N
// in chunks of kSampleChunk samples by pointer offset.  Samples are
// independent: the bits do not depend on the chunking.  The dw stage
// takes any N (at most DW_BLOCKS splits, 64-bit sample offsets).
constexpr int kSampleChunk = 65535;

// The shared memory that dw_stream_kernel's copy of one sample's dc may
// take: the 232,448 bytes a block may take on sm_90, static and dynamic,
// less 6 KB for the kernel's static arrays (at most 4 * (32 * 15 * 3 + 15)
// = 5,820 bytes, which the compiler pads).
constexpr long long kDwStreamDcBytes = 232448 - 6 * 1024;

// Whether dw_stream_kernel holds one sample's dc, cout x (len + 2) f32:
// the one shape limit of the layer's kernels, and only where the backward
// computes dw below kDwStreamBelow output channels (conv3.py:
// dw_stream_max_len).
bool dw_stream_fits(int cout, int len) {
  return cout >= kDwStreamBelow ||
         (long long)sizeof(float) * cout * (len + 2LL) <= kDwStreamDcBytes;
}

// Any non-empty shape; with dw, what dw_stream_fits.
bool shape_ok(int n, int cin, int cout, int len, bool dw) {
  return n > 0 && cin > 0 && cout > 0 && len > 0 && (!dw || dw_stream_fits(cout, len));
}

// Runs f(n0, nc) on the samples [n0, n0 + nc) of each chunk, in order,
// until one returns an error.
template <typename F>
cudaError_t over_samples(int n, F f) {
  for (int n0 = 0; n0 < n; n0 += kSampleChunk) {
    const cudaError_t err = f(n0, n - n0 < kSampleChunk ? n - n0 : kSampleChunk);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// The tiling of the bf16 path on mma.sync (conv3.py: DW_TILE_O, DW_TILE_C).
using DwMain = DwTile<64, 32, 64, 3, 2, 2>;

enum ConvPath { kPathNone = 0, kPathMma = 1, kPathStream = 2, kPathWgmma = 3 };

// dw's first stage for n samples (conv3.py's dw_plan mirrors it): its path
// (below kDwStreamBelow output channels the stream; else f32 on the
// warpgroup MMA, bf16 on mma.sync) and the sample splits that keep one
// wave of blocks: four stream blocks an SM, one warpgroup-MMA block, two
// DwMain blocks, as many as the samples allow.
struct DwPlan {
  int path;
  int nsplit;
};

DwPlan dw_plan(int n, int cin, int cout, bool f32) {
  int path, tiles, blocks;
  if (cout < kDwStreamBelow) {
    path = kPathStream, tiles = (int)cdiv(cin, kDwStreamC), blocks = 4 * kWgBlocks;
  } else if (f32) {
    path = kPathWgmma, tiles = dw_wg_tiles<DwWgTile>(cin, cout), blocks = kWgBlocks;
  } else {
    path = kPathMma, tiles = (int)(cdiv(cout, DwMain::BM) * cdiv(cin, DwMain::BC));
    blocks = 2 * kWgBlocks;
  }
  const int nsplit = blocks / tiles < n ? blocks / tiles : n;
  return {path, nsplit < 1 ? 1 : nsplit};
}

// Stage 1 of dw on the streaming path, with the vector width that x's
// alignment and len allow (16 bytes at most).
template <typename T, int OMAX>
cudaError_t launch_dw_stream(const float* dc, const T* x, float* part, int n, int cin, int cout,
                             int len, int nsplit, cudaStream_t stream) {
  const size_t smem = (size_t)cout * (len + 2) * sizeof(float);
  const dim3 grid((cin + kDwStreamC - 1) / kDwStreamC, nsplit);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  constexpr int kWide = 16 / sizeof(T);
  const auto kernel = len % kWide == 0 && addr % (kWide * sizeof(T)) == 0
                          ? &dw_stream_kernel<T, OMAX, kWide>
                      : len % 2 == 0 && addr % (2 * sizeof(T)) == 0
                          ? &dw_stream_kernel<T, OMAX, 2>
                          : &dw_stream_kernel<T, OMAX, 1>;
  return launch_dw_stage1<T>(kernel, grid, (int)smem, dc, x, part, n, cin, cout, len, nsplit,
                             stream);
}

// dc = dy as f32 in the linear mode: dy itself on f32 (the scratch dc is
// then unused), else converted into dc.
template <typename T>
const float* dc_linear(const void* dy, void* dc, int n, int cout, int len, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return static_cast<const float*>(dy);
  } else {
    const size_t count = (size_t)n * cout * len;
    dc_linear_kernel<T><<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<float*>(dc), count);
    return static_cast<const float*>(dc);
  }
}

// The dw pass: dw (cout, cin, 3) and db (cout,) in f32 from the f32 dc,
// through the f32 scratch part (nsplit, cout, 3 * cin), or (nsplit, cout,
// 3 * cin + 1) on the streaming path (cout < kDwStreamBelow).
template <typename T>
cudaError_t launch_dw(const float* dcp, const T* xp, void* dw, void* db, void* part, int n,
                      int cin, int cout, int len, int nsplit, cudaStream_t stream) {
  cudaError_t err;
  float* partp = static_cast<float*>(part);
  int stride = 3 * cin;
  if (cout < kDwStreamBelow) {
    stride += 1;  // db's partial sums ride in part's last column
    err = cout == 1
              ? launch_dw_stream<T, 1>(dcp, xp, partp, n, cin, cout, len, nsplit, stream)
              : launch_dw_stream<T, kDwStreamBelow - 1>(dcp, xp, partp, n, cin, cout, len,
                                                         nsplit, stream);
  } else {
    if constexpr (kIsF32<T>)
      err = launch_dw_wgmma<DwWgTile>(dcp, xp, partp, n, cin, cout, len, nsplit, stream);
    else
      err = launch_dw_mma<DwMain>(dcp, xp, partp, n, cin, cout, len, nsplit, stream);
    if (err != cudaSuccess) return err;
    db_kernel<<<cout, kThreads, 0, stream>>>(dcp, static_cast<float*>(db), n, cout, len);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int count = cout * stride;
  dw_reduce_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partp, static_cast<float*>(dw), static_cast<float*>(db), cin, cout, stride, nsplit);
  return cudaGetLastError();
}

// ---- the layer's launchers ---------------------------------------------------

// The conv passes of a layer: the forward (K1f, K2f), the recompute of c
// at the head of the dc pass (K1b, K2dx, K2dw), and dx (K1b, K2dx).
enum ConvPass { kPassFwd = 0, kPassDc = 1, kPassDx = 2 };

// A pass's launch plan for n samples (conv3.py's conv_plan mirrors it; the
// launchers take the plan of each chunk of samples): the conv kernel's
// path (f32: the warpgroup-MMA core; bf16: the mma.sync core; below
// kConvStreamBelow output channels the streams) and grid, the tiles the
// grid walks (the warpgroup-MMA core's (step tiles, column tiles,
// samples), walked by a persistent grid; elsewhere the grid itself), the
// row pass's blocks (row_kernel; 0: none), its pieces a row where the
// in_relu forward's rows are longer than kRowPiece (row_part_kernel,
// row_sum_kernel and row_apply_kernel; 0: none), and whether the forward
// writes c into the wrapper's f32 scratch (n, cout, len) first; with row
// pieces the scratch holds their (n, cout, row_parts) float2 partial sums
// after c, from the next even element, then the (n, cout) float2 row sums.
struct ConvPlan {
  int path;
  dim3 grid;
  dim3 tiles;
  int row_blocks;
  int row_parts;
  bool scratch;
};

ConvPlan conv_plan(int n, int cin, int cout, int len, int mode, int pass, bool f32) {
  ConvPlan p{kPathNone, dim3(0, 0, 0), dim3(0, 0, 0), 0, 0, false};
  if (pass == kPassDc && mode == kLinear) return p;  // dc = dy
  // the product's columns: the output channels, or for dx (K = 3 * cout)
  // the input channels; below 16 output channels a stream over x or dc
  const int cols = pass == kPassDx ? cin : cout;
  const bool stream = cout < kConvStreamBelow;
  if (stream) {
    p.path = kPathStream;
    p.grid = p.tiles = dim3(cdiv(len, kStreamSteps), n, 1);
  } else if (f32) {
    p.path = kPathWgmma;
    p.tiles = dim3(cdiv(len, wg_tile_m(cols)), cdiv(cols, wg_tile_n(cols)), n);
    const long long tiles = (long long)p.tiles.x * p.tiles.y * p.tiles.z;
    p.grid = dim3((unsigned)(tiles < kWgBlocks ? tiles : kWgBlocks), 1, 1);
  } else {
    p.path = kPathMma;
    p.grid = p.tiles = dim3(cdiv(len, MmaTile::BN), cdiv(cols, MmaTile::BM), n);
  }
  if (pass == kPassDx) return p;
  // the conv kernels' epilogues add the bias and relu; the rest is the row pass's
  const bool row = mode == kInRelu || (mode == kRelu && (stream || pass == kPassDc));
  const bool pieces = pass == kPassFwd && mode == kInRelu && len > kRowPiece;
  p.row_blocks = row && !pieces ? (int)cdiv((long long)n * cout, kWarps) : 0;
  p.row_parts = pieces ? (int)cdiv(len, kRowPiece) : 0;
  p.scratch = pass == kPassFwd && row;
  return p;
}

// The f32 elements of the split weights that the warpgroup-MMA core reads
// for a product of cols columns over kdim source channels (conv3.py:
// wsplit_numel).
long long wsplit_numel(int kdim, int cols) {
  const int bn = wg_tile_n(cols);
  return (long long)cdiv(cols, bn) * cdiv(kdim, kWgBC) * 2 * 3 * bn * kWgBC;
}

template <int BN>
cudaError_t launch_wsplit_bn(const float* w, float* ws, int kdim, int cols, bool transw,
                             cudaStream_t stream) {
  const int nks = (int)cdiv(kdim, kWgBC);
  const long long count = (long long)cdiv(cols, BN) * nks * 3 * BN * kWgBC;
  conv_weight_split_kernel<BN><<<cdiv(count, kThreads), kThreads, 0, stream>>>(
      w, ws, kdim, cols, transw ? 1 : 0, nks, count);
  return cudaGetLastError();
}

// The split weights ws (wsplit_numel(kdim, cols) floats) for the
// warpgroup-MMA core's product; transw: dx's weights.
cudaError_t launch_wsplit(const float* w, float* ws, int kdim, int cols, bool transw,
                          cudaStream_t stream) {
  if (ws == nullptr) return cudaErrorInvalidValue;
  switch (wg_tile_n(cols)) {
    case 8: return launch_wsplit_bn<8>(w, ws, kdim, cols, transw, stream);
    case 16: return launch_wsplit_bn<16>(w, ws, kdim, cols, transw, stream);
    case 32: return launch_wsplit_bn<32>(w, ws, kdim, cols, transw, stream);
    case 64: return launch_wsplit_bn<64>(w, ws, kdim, cols, transw, stream);
    default: return launch_wsplit_bn<128>(w, ws, kdim, cols, transw, stream);
  }
}

// out (n, cols, len) in f32 = (bias if bias) + the product over src (n,
// kdim, len) with the split weights ws, relu'd where relu, on the plan's
// grid, with the tiling Tile.
template <typename Tile>
cudaError_t launch_wgmma_tile(const ConvPlan& p, const float* src, const float* ws,
                              const float* bias, float* out, int kdim, int cols, int len,
                              bool relu, cudaStream_t stream) {
  using Kernel = void (*)(const float*, const float*, const float*, float*, int, int, int, int,
                          int, int, int, int);
  constexpr Kernel kernel = conv_mma_kernel<Tile>;
  const cudaError_t e = allow_smem<kernel>(Tile::kSmemBytes);
  if (e != cudaSuccess) return e;
  const int pairs = len % 2 == 0 && reinterpret_cast<uintptr_t>(src) % 8 == 0;
  kernel<<<p.grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      src, ws, bias, out, kdim, cols, len, (int)p.tiles.x, (int)p.tiles.y, (int)p.tiles.z,
      relu ? 1 : 0, pairs);
  return cudaGetLastError();
}

cudaError_t launch_conv_wgmma(const ConvPlan& p, const float* src, const float* ws,
                              const float* bias, float* out, int kdim, int cols, int len,
                              bool relu, cudaStream_t stream) {
  using F = cudaError_t (*)(const ConvPlan&, const float*, const float*, const float*, float*,
                            int, int, int, bool, cudaStream_t);
  const int bn = wg_tile_n(cols);
  const F launch = bn == 8    ? &launch_wgmma_tile<WgChoice<8>::Tile>
                   : bn == 16 ? &launch_wgmma_tile<WgChoice<16>::Tile>
                   : bn == 32 ? &launch_wgmma_tile<WgChoice<32>::Tile>
                   : bn == 64 ? &launch_wgmma_tile<WgChoice<64>::Tile>
                              : &launch_wgmma_tile<WgChoice<128>::Tile>;
  return launch(p, src, ws, bias, out, kdim, cols, len, relu, stream);
}

// The bf16 core.
template <typename TB, typename TOUT, bool TRANSW, bool RELU>
cudaError_t launch_conv_mma(dim3 grid, const TB* src, const __nv_bfloat16* w,
                            const __nv_bfloat16* bias, TOUT* out, int kdim, int mdim, int len,
                            cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr auto kPairs = &conv_mma_kernel<MmaTile, T, TB, TOUT, TRANSW, RELU, true>;
  constexpr auto kSingle = &conv_mma_kernel<MmaTile, T, TB, TOUT, TRANSW, RELU, false>;
  const bool pairs = len % 2 == 0 &&
                     (!std::is_same<TB, float>::value ||
                      reinterpret_cast<uintptr_t>(src) % 8 == 0) &&
                     reinterpret_cast<uintptr_t>(out) % (2 * sizeof(TOUT)) == 0;
  const cudaError_t e = pairs ? allow_smem<kPairs>(MmaTile::kSmemBytes)
                              : allow_smem<kSingle>(MmaTile::kSmemBytes);
  if (e != cudaSuccess) return e;
  const auto kernel = pairs ? kPairs : kSingle;
  kernel<<<grid, kThreads, MmaTile::kSmemBytes, stream>>>(src, w, bias, out, kdim, mdim, len);
  return cudaGetLastError();
}

// The streaming forward with 8-byte (f32) or 4-byte (bf16) loads where T
// and x's alignment allow.
template <typename T, typename TOUT>
cudaError_t launch_conv_stream(dim3 grid, const T* x, const T* w, const T* bias, TOUT* out,
                               int cin, int cout, int len, cudaStream_t stream) {
  const bool vec = len % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  constexpr int kMax = kConvStreamBelow - 1;
  const auto kernel = cout == 1 ? (vec ? &conv_stream_kernel<T, TOUT, 1, 2>
                                       : &conv_stream_kernel<T, TOUT, 1, 1>)
                                : (vec ? &conv_stream_kernel<T, TOUT, kMax, 2>
                                       : &conv_stream_kernel<T, TOUT, kMax, 1>);
  kernel<<<grid, kThreads, 0, stream>>>(x, w, bias, out, cin, cout, len);
  return cudaGetLastError();
}

// dx below kConvStreamBelow output channels, with 8-byte (f32) or 4-byte
// (bf16) stores where T and dx's alignment allow.
template <typename T>
cudaError_t launch_dx_stream(dim3 grid, const float* dc, const T* w, T* dx, int cin, int cout,
                             int len, cudaStream_t stream) {
  const bool vec = len % 2 == 0 && reinterpret_cast<uintptr_t>(dx) % (2 * sizeof(T)) == 0;
  constexpr int kMax = kConvStreamBelow - 1;
  const auto kernel = cout == 1 ? (vec ? &dx_stream_kernel<T, 1, 2> : &dx_stream_kernel<T, 1, 1>)
                                : (vec ? &dx_stream_kernel<T, kMax, 2>
                                       : &dx_stream_kernel<T, kMax, 1>);
  kernel<<<grid, kThreads, 0, stream>>>(dc, w, dx, cin, cout, len);
  return cudaGetLastError();
}

// The weights of a pass's product, split for the warpgroup-MMA core into
// ws where the plan (of all n samples) takes it: once a launch, for every
// chunk of samples.
template <typename T>
cudaError_t prepare_weights(const ConvPlan& p, const T* w, float* ws, int kdim, int cols,
                            bool transw, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (p.path == kPathWgmma) return launch_wsplit(w, ws, kdim, cols, transw, stream);
  }
  return cudaSuccess;
}

// out = conv1d(x, w, padding=1) + b (relu'd with RELU, which only the
// tensor-core paths take) on the plan's path, for the plan's samples; ws:
// the split weights (prepare_weights).
template <typename T, typename TOUT, bool RELU>
cudaError_t launch_layer_conv(const ConvPlan& p, const T* x, const T* w, const float* ws,
                              const T* b, TOUT* out, int cin, int cout, int len,
                              cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (p.path == kPathWgmma)
      return launch_conv_wgmma(p, x, ws, b, out, cin, cout, len, RELU, stream);
  } else {
    if (p.path == kPathMma)
      return launch_conv_mma<T, TOUT, false, RELU>(p.grid, x, w, b, out, cin, cout, len, stream);
  }
  if constexpr (!RELU) {
    if (p.path == kPathStream)
      return launch_conv_stream<T, TOUT>(p.grid, x, w, b, out, cin, cout, len, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int ROW>
cudaError_t launch_row(int blocks, float* c, const T* dy, T* y, int rows, int len,
                       cudaStream_t stream, float* dc = nullptr, float2* stats = nullptr) {
  row_kernel<T, ROW><<<blocks, kThreads, 0, stream>>>(c, dy, y, dc, stats, rows, len);
  return cudaGetLastError();
}

// The row passes in pieces over c (rows of ld floats, len steps): the
// partial sums into part, the row sums into sums, then y normalized over
// count steps.
cudaError_t launch_row_sums(const float* c, int ld, float2* part, float2* sums, int rows,
                            int len, cudaStream_t stream) {
  const int parts = (int)cdiv(len, kRowPiece);
  row_part_kernel<<<dim3(rows, parts), kThreads, 0, stream>>>(c, part, len, ld, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_sum_kernel<<<cdiv(rows, kWarps), kThreads, 0, stream>>>(part, sums, rows, parts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_row_apply(const float* c, int ld, const float2* sums, T* y, int rows, int len,
                             int count, cudaStream_t stream) {
  row_apply_kernel<T><<<dim3(rows, cdiv(len, kRowPiece)), kThreads, 0, stream>>>(
      c, ld, sums, y, len, (float)count);
  return cudaGetLastError();
}

// The layer's forward (K1f: the in_relu mode; K2f): y (n, cout, len) in
// T; c is the f32 scratch (n, cout, len) where conv_plan asks for one,
// else null; ws the split weights (wsplit_numel(cin, cout) floats) where
// the plan takes the warpgroup-MMA core, else null.
template <typename T, int MODE>
cudaError_t launch_layer_fwd(const void* x, const void* w, const void* b, void* y, void* c,
                             void* ws, int n, int cin, int cout, int len, cudaStream_t stream) {
  const ConvPlan whole = conv_plan(n, cin, cout, len, MODE, kPassFwd, kIsF32<T>);
  if (whole.scratch != (c != nullptr) || (whole.path == kPathWgmma) != (ws != nullptr))
    return cudaErrorInvalidValue;
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  float* wsp = static_cast<float*>(ws);
  const cudaError_t err = prepare_weights<T>(whole, wp, wsp, cin, cout, false, stream);
  if (err != cudaSuccess) return err;
  return over_samples(n, [&](int n0, int nc) {
    const ConvPlan p = conv_plan(nc, cin, cout, len, MODE, kPassFwd, kIsF32<T>);
    const T* xp = static_cast<const T*>(x) + (size_t)n0 * cin * len;
    T* yp = static_cast<T*>(y) + (size_t)n0 * cout * len;
    if constexpr (MODE == kLinear) {
      return launch_layer_conv<T, T, false>(p, xp, wp, wsp, bp, yp, cin, cout, len, stream);
    } else {
      if constexpr (MODE == kRelu) {
        if (!p.scratch)
          return launch_layer_conv<T, T, true>(p, xp, wp, wsp, bp, yp, cin, cout, len, stream);
      }
      float* cp = static_cast<float*>(c) + (size_t)n0 * cout * len;
      const cudaError_t err =
          launch_layer_conv<T, float, false>(p, xp, wp, wsp, bp, cp, cin, cout, len, stream);
      if (err != cudaSuccess) return err;
      if (p.row_parts > 0) {
        float2* part = reinterpret_cast<float2*>(static_cast<float*>(c) +
                                                 (((size_t)n * cout * len + 1) & ~(size_t)1));
        float2* sums = part + (size_t)n * cout * p.row_parts + (size_t)n0 * cout;
        part += (size_t)n0 * cout * p.row_parts;
        const cudaError_t e = launch_row_sums(cp, len, part, sums, nc * cout, len, stream);
        if (e != cudaSuccess) return e;
        return launch_row_apply<T>(cp, len, sums, yp, nc * cout, len, len, stream);
      }
      constexpr int kRow = MODE == kInRelu ? kRowInReluFwd : kRowReluFwd;
      return launch_row<T, kRow>(p.row_blocks, cp, nullptr, yp, nc * cout, len, stream);
    }
  });
}

// The time-sharded in_relu forward's first phase (K1f over one block of a
// record split along time): c = conv1d(xh, w, padding 1) + b over the
// halo'd block xh (n, cin, len + 2) into the f32 scratch c (n, cout,
// len + 2), whose columns 1 .. len are the block's conv with its
// neighbours' edge columns; then each row's (s, q) over those len columns
// into sums (n * cout float2), through part (n * cout * row_pieces(len)
// float2): the one-launch path's row_part_kernel and row_sum_kernel, at
// any len.  ws as for launch_layer_fwd, at len + 2 steps.
int row_pieces(int len) { return (int)cdiv(len, kRowPiece); }

template <typename T>
cudaError_t launch_layer_part(const void* xh, const void* w, const void* b, void* c, void* part,
                              void* sums, void* ws, int n, int cin, int cout, int len,
                              cudaStream_t stream) {
  const int lh = len + 2, parts = row_pieces(len);
  const ConvPlan whole = conv_plan(n, cin, cout, lh, kInRelu, kPassFwd, kIsF32<T>);
  if ((whole.path == kPathWgmma) != (ws != nullptr)) return cudaErrorInvalidValue;
  float* wsp = static_cast<float*>(ws);
  const cudaError_t err =
      prepare_weights<T>(whole, static_cast<const T*>(w), wsp, cin, cout, false, stream);
  if (err != cudaSuccess) return err;
  return over_samples(n, [&](int n0, int nc) {
    const ConvPlan p = conv_plan(nc, cin, cout, lh, kInRelu, kPassFwd, kIsF32<T>);
    float* cp = static_cast<float*>(c) + (size_t)n0 * cout * lh;
    const cudaError_t err = launch_layer_conv<T, float, false>(
        p, static_cast<const T*>(xh) + (size_t)n0 * cin * lh, static_cast<const T*>(w), wsp,
        static_cast<const T*>(b), cp, cin, cout, lh, stream);
    if (err != cudaSuccess) return err;
    return launch_row_sums(cp + 1, lh, static_cast<float2*>(part) + (size_t)n0 * cout * parts,
                           static_cast<float2*>(sums) + (size_t)n0 * cout, nc * cout, len,
                           stream);
  });
}

// Its second phase: y (n, cout, len) in T = relu((c - mean) * rsig) over
// c's columns 1 .. len, with each row's mean and rsig from its sums (the
// first phase's, summed over the ranks) and the record's length count:
// the one-launch path's row_apply_kernel.
template <typename T>
cudaError_t launch_layer_apply(const void* c, const void* sums, void* y, int n, int cout, int len,
                               int count, cudaStream_t stream) {
  const int lh = len + 2;
  return over_samples(n, [&](int n0, int nc) {
    return launch_row_apply<T>(static_cast<const float*>(c) + (size_t)n0 * cout * lh + 1, lh,
                               static_cast<const float2*>(sums) + (size_t)n0 * cout,
                               static_cast<T*>(y) + (size_t)n0 * cout * len, nc * cout, len,
                               count, stream);
  });
}

// The layer's backward (K1b: the in_relu mode; K2dx, K2dw) for the output
// cotangent dy (n, cout, len): dc into the f32 scratch dc (n, cout, len)
// (c recomputed there, then the row pass over it; dy itself in the f32
// linear mode), then dx (n, cin, len) in T unless dx is null, then dw
// (cout, cin, 3) and db (cout,) in f32 unless dw is null, through the f32
// scratch part (launch_dw).  ws: the split weights of the recompute and of
// dx in turn (the larger of wsplit_numel(cin, cout) and wsplit_numel(cout,
// cin) floats) where either takes the warpgroup-MMA core, else null.
// keep (relu and in_relu only, else null): an f32 (n, cout, len) that
// keeps the recomputed c, the row pass writing dc beside it; stats (given
// with keep in the in_relu mode, else null): n * cout float2, each row's
// (mean, E[c^2] - mean^2) as the row pass took them.
template <typename T, int MODE>
cudaError_t launch_layer_bwd(const void* x, const void* w, const void* b, const void* dy,
                             void* dx, void* dw, void* db, void* dc, void* part, void* ws,
                             void* keep, void* stats, int n, int cin, int cout, int len,
                             int nsplit, cudaStream_t stream) {
  if ((MODE == kLinear && keep != nullptr) ||
      (stats != nullptr) != (MODE == kInRelu && keep != nullptr))
    return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  float* wsp = static_cast<float*>(ws);
  const float* dcp = static_cast<const float*>(dc);
  const ConvPlan dc_whole = conv_plan(n, cin, cout, len, MODE, kPassDc, kIsF32<T>);
  const ConvPlan dx_whole = conv_plan(n, cin, cout, len, MODE, kPassDx, kIsF32<T>);
  const bool split = dc_whole.path == kPathWgmma || (dx != nullptr && dx_whole.path == kPathWgmma);
  if (split != (ws != nullptr)) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (MODE == kLinear) {
    dcp = dc_linear<T>(dy, dc, n, cout, len, stream);
    err = cudaGetLastError();
  } else {
    err = prepare_weights<T>(dc_whole, wp, wsp, cin, cout, false, stream);
    if (err != cudaSuccess) return err;
    err = over_samples(n, [&](int n0, int nc) {
      const ConvPlan p = conv_plan(nc, cin, cout, len, MODE, kPassDc, kIsF32<T>);
      const size_t off = (size_t)n0 * cout * len;
      float* dcw = static_cast<float*>(dc) + off;
      float* cw = keep == nullptr ? dcw : static_cast<float*>(keep) + off;
      const cudaError_t e = launch_layer_conv<T, float, false>(
          p, xp + (size_t)n0 * cin * len, wp, wsp, static_cast<const T*>(b), cw, cin, cout,
          len, stream);
      if (e != cudaSuccess) return e;
      constexpr int kRow = MODE == kInRelu ? kRowInReluDc : kRowReluDc;
      return launch_row<T, kRow>(
          p.row_blocks, cw, static_cast<const T*>(dy) + off, nullptr, nc * cout, len, stream,
          keep == nullptr ? nullptr : dcw,
          stats == nullptr ? nullptr : static_cast<float2*>(stats) + (size_t)n0 * cout);
    });
  }
  if (err != cudaSuccess) return err;
  if (dx != nullptr) {
    // a conv from cout channels (dc) to cin channels (dx), w read transposed
    err = prepare_weights<T>(dx_whole, wp, wsp, cout, cin, true, stream);
    if (err != cudaSuccess) return err;
    err = over_samples(n, [&](int n0, int nc) {
      const ConvPlan p = conv_plan(nc, cin, cout, len, MODE, kPassDx, kIsF32<T>);
      const float* dcn = dcp + (size_t)n0 * cout * len;
      T* dxn = static_cast<T*>(dx) + (size_t)n0 * cin * len;
      if (p.path == kPathStream)
        return launch_dx_stream<T>(p.grid, dcn, wp, dxn, cin, cout, len, stream);
      if constexpr (kIsF32<T>)
        return launch_conv_wgmma(p, dcn, wsp, nullptr, dxn, cout, cin, len, false, stream);
      else
        return launch_conv_mma<float, T, true, false>(p.grid, dcn, wp, nullptr, dxn, cout, cin,
                                                      len, stream);
    });
    if (err != cudaSuccess) return err;
  }
  if (dw == nullptr) return err;
  return launch_dw<T>(dcp, xp, dw, db, part, n, cin, cout, len, nsplit, stream);
}

}  // namespace
}  // namespace scgrhc

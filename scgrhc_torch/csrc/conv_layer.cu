// The conv layer: conv1d(k=3, p=1) + bias, then linear, relu or in_relu,
// with its two backward halves.  The generator's layer is the in_relu mode
// (K1f, K1b); the critic's takes all three (K2f, K2dx, K2dw).  Both reach
// the device code of conv3.cuh through the same entry points:
// scgrhc_layer_fwd and scgrhc_layer_bwd.
//
// K1f replaces scgrhc/ops/pallas/conv_block.py::_fwd_kernel and K1b its
// _bwd_kernel (the custom_vjp's _cir_bwd); K2f, K2dx and K2dw replace
// scgrhc/ops/pallas/critic_fused.py's _fwd_kernel, _bwd_dx_kernel (the
// input gradient: every critic backward and the gradient penalty's
// input-gradient pass) and _bwd_dwdb_kernel (the parameter gradients).
// The in_relu mode:
//   c[t] = b[o] + sum_i w[o,i,0]*x[i,t-1] + w[o,i,1]*x[i,t] + w[o,i,2]*x[i,t+1]
//   y[t] = max((c[t] - mean) * rsqrt(var + 1e-5), 0), stored in x's dtype;
// the backward recomputes c, then dx (skipped when the wrapper passes no
// dx), dw and db summed over samples in f32.  The critic's TPU kernels
// worked in a flat (C, B*T^) layout padded to 128-column tiles, a
// constraint of Mosaic's lane tiling and not of the math; here the layout
// stays (N, C, T), so a layer with padding=1 needs no pad columns.  The
// TPU's dx is unmasked at its pad columns and those values never reach a
// result, so the two agree on every real column.
//
// What bounds it: operations.  A layer does 6*C_in*O*T FLOPs per sample in
// the forward on (C_in + O)*T elements of traffic (the generator's
// bottleneck layer: 1.17 GFLOP against 3 MB per window), far above the
// H100's ridge point; the backward adds a recompute of c (but in the linear
// mode), dx and dw.  The exception is the critic's 512 -> 1 score layer,
// where reading x dominates.  Every product runs on the tensor cores
// (3xTF32 for f32, which keeps f32's accuracy, or bf16): the conv, the dc
// pass's recompute and dx on the conv core (f32 on Hopper's warpgroup MMA,
// bf16 on mma.sync; conv3.cuh, above conv_mma_kernel), dw on the dw stage
// (the same split; conv3.cuh, above dw_mma_kernel).  Below 16 output
// channels the forward streams over x, dx over dc and dw over x, each at
// the byte bound.
//
// Design: the TPU kernel held a whole (C_in, T) sample in VMEM; a 512 x 750
// f32 sample is 1.5 MB, far over a block's shared memory.  Here the core
// tiles (T, O) (f32: 128 steps x up to 128 channels on Hopper's warpgroup
// MMA, with the weights split once a launch into a scratch the wrapper
// allocates) and, in the modes with a row pass, writes c to an f32 scratch
// (N, O, T) that the wrapper allocates (780 MB at N = 512, O = 512,
// T = 744); row_kernel, a warp per (n, o) row, takes the instance norm's
// statistics over T in a fixed order and writes y.  Rows past 8192 steps
// (the continuous mode's whole record) are cut into pieces of a block
// each, their partial sums added in a fixed order (row_part_kernel,
// row_sum_kernel, row_apply_kernel).  The round trip of c costs bytes the
// operations dwarf, and no pass holds a whole row, so T has no limit.  The
// backward recomputes c into the dc scratch and turns it into dc in place;
// the TPU kernel's cross-sample dw sum ran down a sequential grid, here it
// is a two-stage reduction in a fixed order.
//
// The gradient penalty's second order (the vjp of K2dx, critic_fused.py:
// BwdDx.backward) runs on the same launchers in f32: the forward core for
// v = conv(u, w), the dw product twice, dx, and between them one row pass
// of its own, dx_vjp_row_kernel below, on the c and row statistics that
// K2dx's dc pass kept.
//
// Time-sharded (models/cp.py's apply_cp: a record split along time over
// ranks, which scgrhc/models/cp.py runs as an XLA conv with
// _instance_norm_global): a row's statistics span every rank's block, so
// the generator's layer runs in two entry points with a cross-rank sum of
// the (s, q) pairs between them (the wrapper's all-reduce).
// scgrhc_conv_in_relu_part takes the block with its neighbours' edge
// columns, x (n, cin, len + 2), and launches the unchanged conv core over
// those len + 2 steps (zero padding at the halo'd block's own ends, as at
// any layer); the row passes then read c's columns 1 .. len.  The other
// way, teaching the core to read a halo column at each end of its slab,
// would touch the staging of every layer of both models for 2 of len + 2
// columns a row (at a 600-s record over two ranks, 150,002 steps: 0.001 %
// of the work), and the wrapper's copy of the halo'd block costs bytes the
// operations dwarf.  The phases run the one-launch path's row kernels
// (row_part_kernel and row_sum_kernel, then row_apply_kernel), so one
// rank's block gives the whole-record layer's bits;
// scgrhc_conv_in_relu_apply normalizes with the record's length.

#include "conv3.cuh"

using namespace scgrhc;

namespace {

template <typename T>
cudaError_t fwd(int mode, const void* x, const void* w, const void* b, void* y, void* c, void* ws,
                int n, int cin, int cout, int len, cudaStream_t s) {
  switch (mode) {
    case kLinear: return launch_layer_fwd<T, kLinear>(x, w, b, y, c, ws, n, cin, cout, len, s);
    case kRelu: return launch_layer_fwd<T, kRelu>(x, w, b, y, c, ws, n, cin, cout, len, s);
    case kInRelu: return launch_layer_fwd<T, kInRelu>(x, w, b, y, c, ws, n, cin, cout, len, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd(int mode, const void* x, const void* w, const void* b, const void* dy,
                void* dx, void* dw, void* db, void* dc, void* part, void* ws, void* keep,
                void* stats, int n, int cin, int cout, int len, int nsplit, cudaStream_t s) {
  switch (mode) {
    case kLinear:
      return launch_layer_bwd<T, kLinear>(x, w, b, dy, dx, dw, db, dc, part, ws, keep, stats,
                                          n, cin, cout, len, nsplit, s);
    case kRelu:
      return launch_layer_bwd<T, kRelu>(x, w, b, dy, dx, dw, db, dc, part, ws, keep, stats, n,
                                        cin, cout, len, nsplit, s);
    case kInRelu:
      return launch_layer_bwd<T, kInRelu>(x, w, b, dy, dx, dw, db, dc, part, ws, keep, stats,
                                          n, cin, cout, len, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// A kernel lives in a named namespace here: beside conv3.cuh's anonymous one
// (visible through the using-directive), a second anonymous namespace makes
// nvcc's generated launch stubs ambiguous.
namespace critic {

// The vjp of K2dx, dx = conv_t(dc, w) with dc = dc_from_dy(dy, c), at the
// cotangent u on dx, between its products: v = conv(u, w) arrives in v and
// leaves as the cotangent on dy; in the in_relu mode dcc takes the
// cotangent on c, which the linear backward then carries to x, w and b.
// c and each row's (mean, var) are K2dx's own (its dc pass's keep and
// stats), so the masks are those its dc applied; with rsig =
// rsqrt(max(var, 0) + eps), xhat = (c - mean) rsig, m = (xhat > 0) and
// g = m dy, and bars the means over the row's T steps:
//   relu     d_dy = (c > 0) v
//   in_relu  d_dy = m rsig (v - vbar - xhat pv),   pv = mean(v xhat)
//            d_c  = -rsig^2 (pv (g - gbar) + k (v - vbar) + xhat q),
//            k = mean(g xhat), q = mean(v g) - gbar vbar - 3 k pv, and q
//            = 0 where var < 0 (the clamp's zero gradient).
// One warp per (n, o) row, as row_kernel, which reads c, dy and v twice
// (from L1 the second time) and writes v and dcc: bound by bytes, 5 f32
// per element.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
dx_vjp_row_kernel(const float* __restrict__ c, const float2* __restrict__ stats,
                  const float* __restrict__ dy, float* __restrict__ v, float* __restrict__ dcc,
                  int rows, int len) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps
  const size_t base = (size_t)r * len;
  const float* cr = c + base;
  float* vr = v + base;
  if constexpr (MODE == kRelu) {
    for (int t = lane; t < len; t += 32) vr[t] *= step(cr[t]);
  } else {
    const float* dyr = dy + base;
    const float mean = stats[r].x, var = stats[r].y;
    const float rsig = rsqrtf((var < 0.f ? 0.f : var) + kEps);  // row_kernel's
    float sv = 0.f, svx = 0.f, sg = 0.f, sgx = 0.f, svg = 0.f;
    for (int t = lane; t < len; t += 32) {
      const float xh = (cr[t] - mean) * rsig;
      const float g = dyr[t] * step(xh);
      const float vv = vr[t];
      sv += vv;
      svx += vv * xh;
      sg += g;
      sgx += g * xh;
      svg += vv * g;
    }
    const float vbar = warp_sum(sv) / (float)len, pv = warp_sum(svx) / (float)len;
    const float gbar = warp_sum(sg) / (float)len, k = warp_sum(sgx) / (float)len;
    const float mvg = warp_sum(svg) / (float)len;
    const float q = var < 0.f ? 0.f : mvg - gbar * vbar - 3.f * k * pv;
    const float r2 = rsig * rsig;
    float* dcr = dcc + base;
    for (int t = lane; t < len; t += 32) {
      const float xh = (cr[t] - mean) * rsig;
      const float m = step(xh);
      const float g = dyr[t] * m;
      const float vv = vr[t];
      vr[t] = m * (rsig * ((vv - vbar) - xh * pv));
      dcr[t] = -r2 * (pv * (g - gbar) + k * (vv - vbar) + xh * q);
    }
  }
}

}  // namespace critic

// The layer's forward (K1f in the in_relu mode, K2f).  mode: 0 = linear,
// 1 = relu, 2 = in_relu; dtype: 0 = float32, 1 = bfloat16.  x (n, cin,
// len), w (cout, cin, 3), b (cout,) or null, y (n, cout, len), all
// contiguous; c an f32 scratch of n*cout*len (and the row pieces' partial
// sums after it: conv3.py's scratch_numel) where the plan
// (scgrhc_layer_plan, pass 0) asks for one, else null; ws an f32 scratch
// of wsplit_numel(cin, cout) for the f32 core's split weights where the
// plan takes it, else null.  Returns the launch's cudaError_t; no
// synchronise.
extern "C" int scgrhc_layer_fwd(const void* x, const void* w, const void* b, void* y, void* c,
                                void* ws, int n, int cin, int cout, int len, int mode,
                                int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)fwd<float>(mode, x, w, b, y, c, ws, n, cin, cout, len, s);
  if (dtype == 1) return (int)fwd<__nv_bfloat16>(mode, x, w, b, y, c, ws, n, cin, cout, len, s);
  return (int)cudaErrorInvalidValue;
}

// The layer's backward (K1b in the in_relu mode, K2dx, K2dw) for the
// output cotangent dy (n, cout, len): dx (n, cin, len) in the dtype unless
// dx is null (K2dx; K1b for an input that needs no gradient); dw (cout,
// cin, 3) and db (cout,) in float32 unless dw is null (K2dw, K1b).  dc is an f32 scratch of
// n*cout*len; part one of nsplit*cout*(3*cin + (cout < 16)) when dw is
// wanted (conv3.py's dw_plan); ws one for the split weights of the f32
// core's passes, or null where none takes it (conv3.py:
// bwd_wsplit_numel).  keep and stats, or null: what the dc pass leaves for
// the GP's second order (relu and in_relu; stats in_relu only): c in an f32
// keep of n*cout*len, dc then in dc, and each row's (mean, var) in n*cout
// float2 (launch_layer_bwd).
extern "C" int scgrhc_layer_bwd(const void* x, const void* w, const void* b, const void* dy,
                                void* dx, void* dw, void* db, void* dc, void* part, void* ws,
                                void* keep, void* stats, int n, int cin, int cout, int len,
                                int mode, int nsplit, int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len, dw != nullptr) || (dx == nullptr && dw == nullptr) ||
      (dw != nullptr && (db == nullptr || nsplit < 1 || nsplit > n)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(mode, x, w, b, dy, dx, dw, db, dc, part, ws, keep, stats, n, cin,
                           cout, len, nsplit, s);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(mode, x, w, b, dy, dx, dw, db, dc, part, ws, keep, stats, n,
                                   cin, cout, len, nsplit, s);
  return (int)cudaErrorInvalidValue;
}

// The row pass of K2dx's vjp (dx_vjp_row_kernel), float32: c (n, cout,
// len) and stats (n*cout float2) as K2dx's keep and stats left them (stats
// and dcc null in the relu mode), dy (n, cout, len) K2dx's cotangent, v
// (n, cout, len) conv(u, w) in, the cotangent on dy out; dcc (n, cout,
// len) the cotangent on c (in_relu).  mode 1 relu, 2 in_relu.
extern "C" int scgrhc_critic_layer_dx_vjp(const void* c, const void* stats, const void* dy,
                                          void* v, void* dcc, int n, int cout, int len, int mode,
                                          void* stream) {
  const long long rows = (long long)n * cout;
  if (n < 1 || cout < 1 || len < 1 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = cdiv(rows, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(c);
  float* vp = static_cast<float*>(v);
  if (mode == kRelu) {
    critic::dx_vjp_row_kernel<kRelu><<<blocks, kThreads, 0, s>>>(cp, nullptr, nullptr, vp,
                                                                 nullptr, (int)rows, len);
  } else if (mode == kInRelu && stats != nullptr && dcc != nullptr) {
    critic::dx_vjp_row_kernel<kInRelu><<<blocks, kThreads, 0, s>>>(
        cp, static_cast<const float2*>(stats), static_cast<const float*>(dy), vp,
        static_cast<float*>(dcc), (int)rows, len);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The time-sharded forward's first phase: x (n, cin, len + 2) the block
// with its halo columns, c an f32 scratch of n*cout*(len + 2), part one of
// n*cout*ceil(len / 8192) float2, sums (n*cout) float2 out: each row's
// (sum, sum of squares) of c over the block's len steps; ws as for
// scgrhc_layer_fwd.
extern "C" int scgrhc_conv_in_relu_part(const void* x, const void* w, const void* b, void* c,
                                        void* part, void* sums, void* ws, int n, int cin,
                                        int cout, int len, int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len + 2, false) || len < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_layer_part<float>(x, w, b, c, part, sums, ws, n, cin, cout, len, s);
  if (dtype == 1)
    return (int)launch_layer_part<__nv_bfloat16>(x, w, b, c, part, sums, ws, n, cin, cout, len,
                                                 s);
  return (int)cudaErrorInvalidValue;
}

// Its second phase: y (n, cout, len) in the dtype from c and the sums
// (summed over the ranks), normalized over count steps (the record's
// length, count >= len).
extern "C" int scgrhc_conv_in_relu_apply(const void* c, const void* sums, void* y, int n,
                                         int cout, int len, int count, int dtype,
                                         void* stream) {
  if (n < 1 || cout < 1 || len < 1 || count < len) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_layer_apply<float>(c, sums, y, n, cout, len, count, s);
  if (dtype == 1) return (int)launch_layer_apply<__nv_bfloat16>(c, sums, y, n, cout, len, count, s);
  return (int)cudaErrorInvalidValue;
}

// The launch plan of a conv pass (0 forward, 1 the dc pass's recompute,
// 2 dx) for n samples in the dtype (0 float32, 1 bfloat16), as the
// launchers take it for each chunk of samples: out[0..9] = path (0 none,
// 1 mma, 2 stream, 3 wgmma), the grid's x, y, z, the row pass's blocks, 1
// when the forward needs the f32 scratch c, the row pass's pieces a row,
// and the tiles' x, y, z.  conv3.py's conv_plan mirrors it.  out[10] is
// wsplit_numel(cin, cout) (the forward's and the recompute's split
// weights) and out[11] wsplit_numel(cout, cin) (dx's).  Returns 0.
extern "C" int scgrhc_layer_plan(int n, int cin, int cout, int len, int mode, int pass,
                                 int dtype, int* out) {
  const ConvPlan p = conv_plan(n, cin, cout, len, mode, pass, dtype == 0);
  out[0] = p.path;
  out[1] = (int)p.grid.x;
  out[2] = (int)p.grid.y;
  out[3] = (int)p.grid.z;
  out[4] = p.row_blocks;
  out[5] = p.scratch ? 1 : 0;
  out[6] = p.row_parts;
  out[7] = (int)p.tiles.x;
  out[8] = (int)p.tiles.y;
  out[9] = (int)p.tiles.z;
  out[10] = (int)wsplit_numel(cin, cout);
  out[11] = (int)wsplit_numel(cout, cin);
  return 0;
}

// The plan of the dw stage for n samples in the dtype (0 float32, 1
// bfloat16), as launch_dw takes it: out[0] = path (1 mma, 2 stream, 3
// wgmma), out[1] = the sample splits, out[2] = part's columns (3 * cin,
// and db's one more on the stream).  conv3.py's dw_plan mirrors it.
// Returns 0.
extern "C" int scgrhc_dw_plan(int n, int cin, int cout, int dtype, int* out) {
  const DwPlan p = dw_plan(n, cin, cout, dtype == 0);
  out[0] = p.path;
  out[1] = p.nsplit;
  out[2] = 3 * cin + (p.path == kPathStream ? 1 : 0);
  return 0;
}

// The f32 dw stage's launches since the library was loaded, by how its
// rows were copied (conv3.cuh: dw_copy_launches): out[0] by the TMA unit,
// out[1] by cp.async where no tensor map fits, out[2] by cp.async where a
// map fits but could not be made.  conv3.py: dw_copy_launches.  Returns 0.
extern "C" int scgrhc_dw_copy_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = dw_copy_launches[i].load();
  return 0;
}

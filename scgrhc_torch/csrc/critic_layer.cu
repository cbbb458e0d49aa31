// The critic's layer: conv1d(k=3, p=1) + bias, then relu, in_relu or
// linear, with its two backward halves.
//
// Replaces scgrhc/ops/pallas/critic_fused.py: K2f its _fwd_kernel, K2dx
// its _bwd_dx_kernel (the input gradient: every critic backward and the
// gradient penalty's input-gradient pass), K2dw its _bwd_dwdb_kernel (the
// parameter gradients).  The device code is conv3.cuh's in the layer's mode.
// The TPU kernels worked in a flat (C, B*T^) layout padded to 128-column
// tiles, a constraint of Mosaic's lane tiling and not of the math; here the
// layout stays (N, C, T), so a layer with padding=1 needs no pad columns.
// The TPU's dx is unmasked at its pad columns and those values never reach a
// result, so the two agree on every real column.
//
// What bounds it: operations at the critic's widths (6*C*O*T FLOPs per
// sample for the conv; K2dx and K2dw add a recompute of c except in the
// linear mode), except the 512 -> 1 linear layer, where reading x
// dominates.  The conv of the forward, of the dc pass's recompute and of
// dx runs on the tensor cores (conv3.cuh, above conv_mma_kernel: f32 on
// Hopper's warpgroup MMA, bf16 on mma.sync), with a
// row pass for the instance norm and the dc formulas; below 16 output
// channels the forward streams over x and dx over dc, each at the byte
// bound.  K2dw's dw product runs on the tensor cores (f32 on Hopper's
// warpgroup MMA, bf16 on mma.sync), or for the score layer as a stream
// over x (conv3.cuh, above dw_mma_kernel).
// The gradient penalty's second order (the vjp of K2dx, critic_fused.py:
// BwdDx.backward) runs on the same launchers in f32: the forward core for
// v = conv(u, w), the dw product twice, dx, and between them one row pass
// of its own, dx_vjp_row_kernel below, on the c and row statistics that
// K2dx's dc pass kept.

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

// mode: 0 = linear, 1 = relu, 2 = in_relu; dtype: 0 = float32,
// 1 = bfloat16.  x (n, cin, len), w (cout, cin, 3), b (cout,), y (n, cout,
// len), all contiguous; c an f32 scratch of n*cout*len (and the row
// pieces' partial sums after it: conv3.py's scratch_numel) where the plan
// (scgrhc_critic_plan, pass 0) asks for one, else null; ws an f32 scratch
// of wsplit_numel(cin, cout) for the f32 core's split weights where the
// plan takes it, else null.  Returns the launch's cudaError_t; no
// synchronise.
extern "C" int scgrhc_critic_layer_fwd(const void* x, const void* w, const void* b, void* y,
                                       void* c, void* ws, int n, int cin, int cout, int len,
                                       int mode, int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)fwd<float>(mode, x, w, b, y, c, ws, n, cin, cout, len, s);
  if (dtype == 1) return (int)fwd<__nv_bfloat16>(mode, x, w, b, y, c, ws, n, cin, cout, len, s);
  return (int)cudaErrorInvalidValue;
}

// The layer's backward for the output cotangent dy (n, cout, len): dx
// (n, cin, len) in the dtype unless dx is null (K2dx); dw (cout, cin, 3) and
// db (cout,) in float32 unless dw is null (K2dw).  dc is an f32 scratch of
// n*cout*len; part one of nsplit*cout*(3*cin + (cout < 16)) when dw is
// wanted (conv3.py's dw_plan); ws one for the split weights of the f32
// core's passes, or null where none takes it (conv3.py:
// bwd_wsplit_numel).  keep and stats, or null: what the dc pass leaves for
// the GP's second order (relu and in_relu; stats in_relu only): c in an f32
// keep of n*cout*len, dc then in dc, and each row's (mean, var) in n*cout
// float2 (launch_layer_bwd).
extern "C" int scgrhc_critic_layer_bwd(const void* x, const void* w, const void* b,
                                       const void* dy, void* dx, void* dw, void* db,
                                       void* dc, void* part, void* ws, void* keep, void* stats,
                                       int n, int cin, int cout, int len, int mode, int nsplit,
                                       int dtype, void* stream) {
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

// The launch plan of a conv pass (0 forward, 1 the dc pass's recompute,
// 2 dx) for n samples in the dtype (0 float32, 1 bfloat16), as the
// launchers take it for each chunk of samples: out[0..9] = path (0 none,
// 1 mma, 2 stream, 3 wgmma), the grid's x, y, z, the row pass's blocks, 1
// when the forward needs the f32 scratch c, the row pass's pieces a row,
// and the tiles' x, y, z.  conv3.py's conv_plan mirrors it.  out[10] is
// wsplit_numel(cin, cout) (the forward's and the recompute's split
// weights) and out[11] wsplit_numel(cout, cin) (dx's).  Returns 0.
extern "C" int scgrhc_critic_plan(int n, int cin, int cout, int len, int mode, int pass,
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

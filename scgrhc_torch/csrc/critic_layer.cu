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
// bound.  K2dw's dw product runs on the tensor cores, or for the score
// layer as a stream over x (conv3.cuh, above dw_mma_kernel).
// The second-order pass of the gradient penalty is not a kernel: it
// differentiates the plain PyTorch version, as the JAX package
// differentiates its reference under XLA.

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
                void* dx, void* dw, void* db, void* dc, void* part, void* ws, int n, int cin,
                int cout, int len, int nsplit, cudaStream_t s) {
  switch (mode) {
    case kLinear:
      return launch_layer_bwd<T, kLinear>(x, w, b, dy, dx, dw, db, dc, part, ws, n, cin, cout,
                                          len, nsplit, s);
    case kRelu:
      return launch_layer_bwd<T, kRelu>(x, w, b, dy, dx, dw, db, dc, part, ws, n, cin, cout,
                                        len, nsplit, s);
    case kInRelu:
      return launch_layer_bwd<T, kInRelu>(x, w, b, dy, dx, dw, db, dc, part, ws, n, cin, cout,
                                          len, nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

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
// bwd_wsplit_numel).
extern "C" int scgrhc_critic_layer_bwd(const void* x, const void* w, const void* b,
                                       const void* dy, void* dx, void* dw, void* db,
                                       void* dc, void* part, void* ws, int n, int cin, int cout,
                                       int len, int mode, int nsplit, int dtype,
                                       void* stream) {
  if (!shape_ok(n, cin, cout, len, dw != nullptr) || (dx == nullptr && dw == nullptr) ||
      (dw != nullptr && (db == nullptr || nsplit < 1 || nsplit > n)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(mode, x, w, b, dy, dx, dw, db, dc, part, ws, n, cin, cout, len,
                           nsplit, s);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(mode, x, w, b, dy, dx, dw, db, dc, part, ws, n, cin, cout,
                                   len, nsplit, s);
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

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
// What bounds it: operations on the f32 FMA units at the critic's widths
// (6*C*O*T FLOPs per sample for the conv; K2dx and K2dw add a recompute of
// c except in the linear mode), except the 512 -> 1 linear layer, where
// reading x dominates.  The second-order pass of the gradient penalty is
// not a kernel: it differentiates the plain PyTorch version, as the JAX
// package differentiates its reference under XLA.
//
// Design: as conv_in_relu.cu.  O = 1 (conv4) fills one of a block's 16
// channel slots and C_in = 5 (conv0) one chunk of 8; both are masked
// inside the block.

#include "conv3.cuh"

using namespace scgrhc;

namespace {

template <typename T>
cudaError_t fwd(int mode, const void* x, const void* w, const void* b, void* y, int n,
                int cin, int cout, int len, cudaStream_t s) {
  switch (mode) {
    case kLinear: return launch_fwd<T, kLinear>(x, w, b, y, n, cin, cout, len, s);
    case kRelu: return launch_fwd<T, kRelu>(x, w, b, y, n, cin, cout, len, s);
    case kInRelu: return launch_fwd<T, kInRelu>(x, w, b, y, n, cin, cout, len, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd(int mode, const void* x, const void* w, const void* b, const void* dy,
                void* dx, void* dw, void* db, void* dc, void* part, int n, int cin, int cout,
                int len, int nsplit, cudaStream_t s) {
  switch (mode) {
    case kLinear:
      return launch_bwd<T, kLinear>(x, w, b, dy, dx, dw, db, dc, part, n, cin, cout, len,
                                    nsplit, s);
    case kRelu:
      return launch_bwd<T, kRelu>(x, w, b, dy, dx, dw, db, dc, part, n, cin, cout, len,
                                  nsplit, s);
    case kInRelu:
      return launch_bwd<T, kInRelu>(x, w, b, dy, dx, dw, db, dc, part, n, cin, cout, len,
                                    nsplit, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 = linear, 1 = relu, 2 = in_relu; dtype: 0 = float32,
// 1 = bfloat16.  x (n, cin, len), w (cout, cin, 3), b (cout,), y (n, cout,
// len), all contiguous.  Returns the launch's cudaError_t; no synchronise.
extern "C" int scgrhc_critic_layer_fwd(const void* x, const void* w, const void* b, void* y,
                                       int n, int cin, int cout, int len, int mode,
                                       int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)fwd<float>(mode, x, w, b, y, n, cin, cout, len, s);
  if (dtype == 1) return (int)fwd<__nv_bfloat16>(mode, x, w, b, y, n, cin, cout, len, s);
  return (int)cudaErrorInvalidValue;
}

// The layer's backward for the output cotangent dy (n, cout, len): dx
// (n, cin, len) in the dtype unless dx is null (K2dx); dw (cout, cin, 3) and
// db (cout,) in float32 unless dw is null (K2dw).  dc is an f32 scratch of
// n*cout*len; part one of nsplit*cout*3*cin when dw is wanted.
extern "C" int scgrhc_critic_layer_bwd(const void* x, const void* w, const void* b,
                                       const void* dy, void* dx, void* dw, void* db,
                                       void* dc, void* part, int n, int cin, int cout,
                                       int len, int mode, int nsplit, int dtype,
                                       void* stream) {
  if (!shape_ok(n, cin, cout, len) || (dx == nullptr && dw == nullptr) ||
      (dw != nullptr && (db == nullptr || nsplit < 1 || nsplit > n)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(mode, x, w, b, dy, dx, dw, db, dc, part, n, cin, cout, len, nsplit,
                           s);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(mode, x, w, b, dy, dx, dw, db, dc, part, n, cin, cout, len,
                                   nsplit, s);
  return (int)cudaErrorInvalidValue;
}

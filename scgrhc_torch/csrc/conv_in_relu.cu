// The generator's layer: fused conv1d(k=3, p=1) + bias + InstanceNorm + ReLU.
//
// K1f, the forward, replaces scgrhc/ops/pallas/conv_block.py::_fwd_kernel;
// K1b, the backward, replaces its _bwd_kernel (the custom_vjp's _cir_bwd).
// The device code is conv3.cuh's, in the in_relu mode:
//   c[t] = b[o] + sum_i w[o,i,0]*x[i,t-1] + w[o,i,1]*x[i,t] + w[o,i,2]*x[i,t+1]
//   y[t] = max((c[t] - mean) * rsqrt(var + 1e-5), 0), stored in x's dtype;
// the backward recomputes c, then dx (skipped when the wrapper passes no
// dx), dw and db summed over samples in f32.
//
// What bounds it: operations.  A generator layer does 6*C_in*O*T FLOPs per
// sample in the forward on (C_in + O)*T elements of traffic (the
// bottleneck layer: 1.17 GFLOP against 3 MB per window), far above the
// H100's f32 ridge point; the backward does three times that (recompute,
// dx, dw).  All of it runs on the f32 FMA units (67 TFLOP/s); tensor cores
// (wgmma, TMA) are later work.
//
// Design: the TPU kernel held a whole (C_in, T) sample in VMEM; a 512 x 750
// f32 sample is 1.5 MB, far over a block's shared memory.  Here a block
// keeps 16 output channels' full-T conv sums in registers and streams C_in
// through shared memory (conv3.cuh), so the statistics are block
// reductions and c never touches device memory.  The backward needs dc for
// all O channels before dx can start, so dc goes to an f32 scratch the
// wrapper allocates (N*O*T*4 bytes: 48.8 MB at N=32, O=512, T=744); the
// TPU kernel's cross-sample dw sum ran down a sequential grid, here it is
// a two-stage reduction in a fixed order.

#include "conv3.cuh"

using namespace scgrhc;

// x (n, cin, len), w (cout, cin, 3), b (cout,), y (n, cout, len), all
// contiguous and of one dtype: 0 = float32, 1 = bfloat16.  Returns the
// launch's cudaError_t (0 on success); it does not synchronise.
extern "C" int scgrhc_conv_in_relu(const void* x, const void* w, const void* b,
                                   void* y, int n, int cin, int cout, int len,
                                   int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd<float, kInRelu>(x, w, b, y, n, cin, cout, len, s);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16, kInRelu>(x, w, b, y, n, cin, cout, len, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of scgrhc_conv_in_relu for the output cotangent dy
// (n, cout, len): dx (n, cin, len) in the dtype, or skipped when dx is
// null; dw (cout, cin, 3) and db (cout,) in float32.  dc is an f32
// scratch of n*cout*len, part one of nsplit*cout*3*cin (1 <= nsplit <= n).
extern "C" int scgrhc_conv_in_relu_bwd(const void* x, const void* w, const void* b,
                                       const void* dy, void* dx, void* dw, void* db,
                                       void* dc, void* part, int n, int cin, int cout,
                                       int len, int nsplit, int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len) || nsplit < 1 || nsplit > n || dw == nullptr ||
      db == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float, kInRelu>(x, w, b, dy, dx, dw, db, dc, part, n, cin, cout,
                                           len, nsplit, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16, kInRelu>(x, w, b, dy, dx, dw, db, dc, part, n,
                                                   cin, cout, len, nsplit, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int scgrhc_conv_in_relu_max_len() { return kMaxTpt * kThreads; }

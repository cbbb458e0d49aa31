// The generator's layer: fused conv1d(k=3, p=1) + bias + InstanceNorm + ReLU.
//
// K1f, the forward, replaces scgrhc/ops/pallas/conv_block.py::_fwd_kernel;
// K1b, the backward, replaces its _bwd_kernel (the custom_vjp's _cir_bwd).
// The device code is conv3.cuh's, in the in_relu mode, through the same
// launchers as the critic's layer (launch_layer_fwd, launch_layer_bwd):
//   c[t] = b[o] + sum_i w[o,i,0]*x[i,t-1] + w[o,i,1]*x[i,t] + w[o,i,2]*x[i,t+1]
//   y[t] = max((c[t] - mean) * rsqrt(var + 1e-5), 0), stored in x's dtype;
// the backward recomputes c, then dx (skipped when the wrapper passes no
// dx), dw and db summed over samples in f32.
//
// What bounds it: operations.  A generator layer does 6*C_in*O*T FLOPs per
// sample in the forward on (C_in + O)*T elements of traffic (the
// bottleneck layer: 1.17 GFLOP against 3 MB per window), far above the
// H100's ridge point; the backward does three times that (recompute, dx,
// dw).  Every product runs on the tensor cores (3xTF32 for f32, which
// keeps f32's accuracy, or bf16): the conv and dx on the conv core (f32 on
// Hopper's warpgroup MMA, bf16 on mma.sync), dw on the dw stage (f32 on
// the warpgroup MMA, bf16 on mma.sync; conv3.cuh, above conv_mma_kernel
// and dw_mma_kernel).
//
// Design: the TPU kernel held a whole (C_in, T) sample in VMEM; a 512 x 750
// f32 sample is 1.5 MB, far over a block's shared memory.  Here the core
// tiles (T, O) (f32: 128 steps x up to 128 channels on Hopper's warpgroup
// MMA, with the weights split once a launch into a scratch the wrapper
// allocates) and writes c to an f32 scratch (N, O, T) that the
// wrapper allocates (780 MB at N = 512, O = 512, T = 744); row_kernel, a
// warp per (n, o) row, takes the instance norm's statistics over T in a
// fixed order and writes y.  Rows past 8192 steps (the continuous mode's
// whole record) are cut into pieces of a block each, their partial sums
// added in a fixed order (row_part_kernel, row_sum_kernel,
// row_apply_kernel).  The round trip of c costs bytes the
// operations dwarf, and no pass holds a whole row, so T has no limit.  The
// backward recomputes c into the dc scratch and turns it into dc in place;
// the TPU kernel's cross-sample dw sum ran down a sequential grid, here it
// is a two-stage reduction in a fixed order.
//
// Time-sharded (models/cp.py's apply_cp: a record split along time over
// ranks, which scgrhc/models/cp.py runs as an XLA conv with
// _instance_norm_global): a row's statistics span every rank's block, so
// the layer runs in two entry points with a cross-rank sum of the (s, q)
// pairs between them (the wrapper's all-reduce).  scgrhc_conv_in_relu_part
// takes the block with its neighbours' edge columns, x (n, cin, len + 2),
// and launches the unchanged conv core over those len + 2 steps (zero
// padding at the halo'd block's own ends, as at any layer); the row passes
// then read c's columns 1 .. len.  The other way, teaching the core to
// read a halo column at each end of its slab, would touch the staging of
// every layer of both models for 2 of len + 2 columns a row (at a 600-s
// record over two ranks, 150,002 steps: 0.001 % of the work), and the
// wrapper's copy of the halo'd block costs bytes the operations dwarf.
// The phases run the one-launch path's row kernels (row_part_kernel and
// row_sum_kernel, then row_apply_kernel), so one rank's block gives the
// whole-record layer's bits; scgrhc_conv_in_relu_apply normalizes with the
// record's length.

#include "conv3.cuh"

using namespace scgrhc;

// x (n, cin, len), w (cout, cin, 3), b (cout,), y (n, cout, len), all
// contiguous and of one dtype: 0 = float32, 1 = bfloat16; c an f32
// scratch of n*cout*len, with 2*n*cout*(row_parts + 1) more from the next
// even element where the plan cuts rows into pieces (conv3.py's conv_plan,
// in_relu, pass 0; scratch_numel); ws an f32 scratch of
// wsplit_numel(cin, cout) for the f32 core's split weights where the plan
// takes it (conv3.py: wsplit_numel), else null.  Returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int scgrhc_conv_in_relu(const void* x, const void* w, const void* b, void* y,
                                   void* c, void* ws, int n, int cin, int cout, int len,
                                   int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_layer_fwd<float, kInRelu>(x, w, b, y, c, ws, n, cin, cout, len, s);
  if (dtype == 1)
    return (int)launch_layer_fwd<__nv_bfloat16, kInRelu>(x, w, b, y, c, ws, n, cin, cout, len,
                                                         s);
  return (int)cudaErrorInvalidValue;
}

// The backward of scgrhc_conv_in_relu for the output cotangent dy
// (n, cout, len): dx (n, cin, len) in the dtype, or skipped when dx is
// null; dw (cout, cin, 3) and db (cout,) in float32.  dc is an f32
// scratch of n*cout*len, part one of nsplit*cout*(3*cin + (cout < 16))
// (1 <= nsplit <= n; conv3.py's dw_plan), ws one for the split weights of
// the f32 core's passes, or null where none takes it (conv3.py:
// bwd_wsplit_numel).
extern "C" int scgrhc_conv_in_relu_bwd(const void* x, const void* w, const void* b,
                                       const void* dy, void* dx, void* dw, void* db,
                                       void* dc, void* part, void* ws, int n, int cin, int cout,
                                       int len, int nsplit, int dtype, void* stream) {
  if (!shape_ok(n, cin, cout, len, true) || nsplit < 1 || nsplit > n || dw == nullptr ||
      db == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_layer_bwd<float, kInRelu>(x, w, b, dy, dx, dw, db, dc, part, ws,
                                                 nullptr, nullptr, n, cin, cout, len, nsplit, s);
  if (dtype == 1)
    return (int)launch_layer_bwd<__nv_bfloat16, kInRelu>(x, w, b, dy, dx, dw, db, dc, part, ws,
                                                         nullptr, nullptr, n, cin, cout, len,
                                                         nsplit, s);
  return (int)cudaErrorInvalidValue;
}

// The time-sharded forward's first phase: x (n, cin, len + 2) the block
// with its halo columns, c an f32 scratch of n*cout*(len + 2), part one of
// n*cout*ceil(len / 8192) float2, sums (n*cout) float2 out: each row's
// (sum, sum of squares) of c over the block's len steps; ws as for
// scgrhc_conv_in_relu.
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

// Times K3 (csrc/gate_normalize.cu: gate_normalize_kernel) under four launch
// shapes, one block of 32 (a warp a window), 128, 256 or 512 threads per
// window, at the data stage's windows (C = 4, T = 750) for N = 37, 300,
// 2,400 and 19,200, back to back and replayed from a CUDA graph, beside an
// empty kernel on the same grid (the launch floor), a copy kernel that
// moves the same bytes on the same grid (what the bytes alone cost) and
// the byte bound; then back to back at T = 1,500 and 12,289 (N = 300), past
// the scg values the registers hold.  At N = 300 it also times the
// 256-thread shape with win = 1, which runs no level of the flat scan.
// Every shape's outputs are held bit for bit against a host reference:
// keep, the (lo, hi) pairs and the normalized windows (NaN in the same
// places).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/gate_layouts scgrhc_torch/bench/gate_layouts.cu && build/gate_layouts
//
// Windows are pressure-like (a sine near 1.2 Hz plus unit noise around 20,
// from a fixed LCG), with some flat, some a ramp, some dipping below
// min_rhc, some holding a flat run of win or win + 1 samples, and some a
// NaN.

#include <cmath>
#include <cstdio>
#include <cstring>
#include <vector>

#include "../csrc/gate_normalize.cu"

namespace {

constexpr int kWin = 50;
constexpr float kMinRhc = -50.f;
constexpr double kPeakBytes = 3.35e12;

struct Lcg {
  unsigned long long s;
  double uniform() {
    s = s * 6364136223846793005ull + 1442695040888963407ull;
    return ((s >> 11) + 0.5) / 9007199254740992.0;
  }
  double normal() {
    return std::sqrt(-2 * std::log(uniform())) * std::cos(6.283185307179586 * uniform());
  }
};

void make_windows(int n, int c, int t, std::vector<float>& scg, std::vector<float>& rhc) {
  Lcg g{12345};
  scg.resize((size_t)n * c * t);
  rhc.resize((size_t)n * t);
  for (int w = 0; w < n; ++w) {
    const double f = 0.9 + 0.6 * g.uniform(), amp = 0.01 + 2 * g.uniform();
    float* r = &rhc[(size_t)w * t];
    for (int i = 0; i < t; ++i)
      r[i] = (float)(20 + 10 * std::sin(6.283185307179586 * f * i / 500.0) + g.normal());
    for (size_t i = 0; i < (size_t)c * t; ++i)
      scg[(size_t)w * c * t + i] = (float)(amp * g.normal());
    switch (w % 50) {
      case 3: for (int i = 0; i < t; ++i) r[i] = 7.25f; break;
      case 5:
        for (int i = 0; i < t; ++i) r[i] = (float)(30.0 * i / (t - 1) + 0.01 * g.normal());
        break;
      case 7: r[t / 7] = kMinRhc - 30; break;
      case 11: r[t / 3] = NAN; scg[(size_t)w * c * t + t / 2] = NAN; break;
      case 13: for (int i = 0; i < kWin; ++i) r[t / 2 + i] = r[t / 2]; break;       // kept
      case 17: for (int i = 0; i <= kWin; ++i) r[t - kWin - 1 + i] = r[t - 1]; break;  // dropped
    }
  }
}

float nmin(float a, float v) { return (v < a || v != v) ? v : a; }
float nmax(float a, float v) { return (v > a || v != v) ? v : a; }

// keep, (lo, hi) pairs and normalized windows as the plain version defines them
void reference(int n, int c, int t, const std::vector<float>& scg, const std::vector<float>& rhc,
               std::vector<unsigned char>& keep, std::vector<float>& mm_scg,
               std::vector<float>& mm_rhc, std::vector<float>& scg_out,
               std::vector<float>& rhc_out) {
  const size_t m = (size_t)c * t;
  keep.resize(n);
  mm_scg.resize(2 * n);
  mm_rhc.resize(2 * n);
  scg_out.resize(scg.size());
  rhc_out.resize(rhc.size());
  for (int w = 0; w < n; ++w) {
    const float* r = &rhc[(size_t)w * t];
    const float* s = &scg[w * m];
    float lo = INFINITY, hi = -INFINITY, slo = INFINITY, shi = -INFINITY;
    bool below = false;
    double mean = 0;
    for (int i = 0; i < t; ++i)
      lo = nmin(lo, r[i]), hi = nmax(hi, r[i]), below |= r[i] < kMinRhc, mean += r[i];
    for (size_t i = 0; i < m; ++i) slo = nmin(slo, s[i]), shi = nmax(shi, s[i]);
    mean /= t;
    int flat = 0;
    for (int p = 0; p + kWin <= t; ++p) {
      float wl = INFINITY, wh = -INFINITY;
      for (int k = 0; k < kWin; ++k) wl = nmin(wl, r[p + k]), wh = nmax(wh, r[p + k]);
      flat += (wh - wl) < gate::kFlatThreshold;
    }
    double sxx = 0, sxy = 0, syy = 0;
    for (int i = 0; i < t; ++i) {
      const double xc = i - (t - 1) / 2.0, yc = r[i] - mean;
      sxx += xc * xc, sxy += xc * yc, syy += yc * yc;
    }
    const double r2 = sxx * syy > 0 ? sxy * sxy / (sxx * syy) : 1.0;
    keep[w] = !(flat >= 2 || r2 > gate::kR2Threshold || below);
    mm_rhc[2 * w] = lo, mm_rhc[2 * w + 1] = hi, mm_scg[2 * w] = slo, mm_scg[2 * w + 1] = shi;
    const float den = hi - lo + gate::kNormEps, sden = shi - slo + gate::kNormEps;
    for (int i = 0; i < t; ++i) rhc_out[(size_t)w * t + i] = (r[i] - lo) / den;
    for (size_t i = 0; i < m; ++i) scg_out[w * m + i] = (s[i] - slo) / sden;
  }
}

struct Dev {
  float *scg, *rhc, *scg_out, *rhc_out, *mm_scg, *mm_rhc;
  unsigned char* keep;
};

template <int kThreads>
cudaError_t run(const Dev& d, int n, int c, int t, cudaStream_t st) {
  return gate::launch<kThreads>(d.scg, d.rhc, d.scg_out, d.rhc_out, d.keep, d.mm_scg, d.mm_rhc, n,
                                c, t, kWin, kMinRhc, st);
}

template <typename F>
float time_ms(F launch, cudaStream_t st, int reps = 20) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 3; ++i) launch();
  cudaEventRecord(a, st);
  for (int i = 0; i < reps; ++i) launch();
  cudaEventRecord(b, st);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms / reps;
}

// reps launches captured in one CUDA graph, replayed: ms per launch
template <typename F>
float graph_ms(F launch, cudaStream_t st, int reps = 20) {
  cudaGraph_t g;
  cudaGraphExec_t ge;
  launch();
  cudaStreamSynchronize(st);
  cudaStreamBeginCapture(st, cudaStreamCaptureModeThreadLocal);
  for (int i = 0; i < reps; ++i) launch();
  cudaStreamEndCapture(st, &g);
  cudaGraphInstantiate(&ge, g, 0);
  const float ms = time_ms([&] { cudaGraphLaunch(ge, st); }, st, 5) / reps;
  cudaGraphExecDestroy(ge);
  cudaGraphDestroy(g);
  return ms;
}

template <int kThreads>
void empty_launch(int n, cudaStream_t st) {
  gate::empty_kernel<<<n, kThreads, 0, st>>>();
}

// K3's bytes alone: each block reads its window's scg (16-byte loads) and
// rhc and writes them back, all loads in flight before the first store.
__global__ void __launch_bounds__(256) copy_kernel(const float4* scg, const float* rhc,
                                                   float4* scg_out, float* rhc_out, int mv, int t) {
  const size_t n = blockIdx.x;
  float4 v[4];
  float w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = j * 256 + threadIdx.x;
    if (i < mv) v[j] = scg[n * mv + i];
    if (i < t) w[j] = rhc[n * t + i];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = j * 256 + threadIdx.x;
    if (i < mv) scg_out[n * mv + i] = v[j];
    if (i < t) rhc_out[n * t + i] = w[j];
  }
}

int failures = 0;

// equal bits, or NaN on both sides (the card writes its own NaN bits)
bool same_bits(const std::vector<float>& a, const std::vector<float>& b) {
  for (size_t i = 0; i < a.size(); ++i)
    if (std::memcmp(&a[i], &b[i], 4) && !(a[i] != a[i] && b[i] != b[i])) return false;
  return a.size() == b.size();
}

template <int kThreads>
void shape(const Dev& d, int n, int c, int t, cudaStream_t st,
           const std::vector<unsigned char>& keep,
           const std::vector<float>& mm_scg, const std::vector<float>& mm_rhc,
           const std::vector<float>& scg_out, const std::vector<float>& rhc_out, bool graph) {
  const size_t m = (size_t)c * t;
  cudaMemsetAsync(d.scg_out, 0xff, n * m * 4, st);
  cudaMemsetAsync(d.rhc_out, 0xff, (size_t)n * t * 4, st);
  const cudaError_t err = run<kThreads>(d, n, c, t, st);
  cudaStreamSynchronize(st);
  std::vector<unsigned char> k(n);
  std::vector<float> ms(2 * n), mr(2 * n), so(n * m), ro((size_t)n * t);
  cudaMemcpy(k.data(), d.keep, n, cudaMemcpyDeviceToHost);
  cudaMemcpy(ms.data(), d.mm_scg, 8 * n, cudaMemcpyDeviceToHost);
  cudaMemcpy(mr.data(), d.mm_rhc, 8 * n, cudaMemcpyDeviceToHost);
  cudaMemcpy(so.data(), d.scg_out, 4 * n * m, cudaMemcpyDeviceToHost);
  cudaMemcpy(ro.data(), d.rhc_out, 4 * (size_t)n * t, cudaMemcpyDeviceToHost);
  const bool same = err == cudaSuccess && k == keep && same_bits(ms, mm_scg) &&
                    same_bits(mr, mm_rhc) && same_bits(so, scg_out) && same_bits(ro, rhc_out);
  failures += !same;
  int kept = 0;
  for (int i = 0; i < n; ++i) kept += k[i];
  const double bound = (2.0 * 4 * n * (c + 1) * t + n * 17.0) / kPeakBytes * 1e3;
  const float b2b = time_ms([&] { run<kThreads>(d, n, c, t, st); }, st);
  printf("%3d threads N=%5d C=%d T=%5d: %.4f ms back to back", kThreads, n, c, t, b2b);
  if (graph) {  // windows that need no shared-memory opt-in, so nothing but launches is captured
    const float gr = graph_ms([&] { run<kThreads>(d, n, c, t, st); }, st);
    printf(", %.4f ms in a graph (bound %.4f ms, %.0f %%), empty kernel %.4f ms in a graph", gr,
           bound, 100 * bound / gr, graph_ms([&] { empty_launch<kThreads>(n, st); }, st));
  } else {
    printf(" (bound %.4f ms, %.0f %%)", bound, 100 * bound / b2b);
  }
  printf("; kept %d, outputs %s [%s]\n", kept, same ? "equal" : "DIFFER", cudaGetErrorString(err));
}

}  // namespace

int main() {
  cudaStream_t st;
  cudaStreamCreate(&st);
  const int c = 4;
  struct { int n, t; bool graph; } cases[] = {{37, 750, true}, {300, 750, true}, {2400, 750, true},
                                               {19200, 750, true}, {300, 1500, false},
                                               {300, 12289, false}};
  for (const auto& cs : cases) {
    const int n = cs.n, t = cs.t;
    std::vector<float> scg, rhc, mm_scg, mm_rhc, scg_out, rhc_out;
    std::vector<unsigned char> keep;
    make_windows(n, c, t, scg, rhc);
    reference(n, c, t, scg, rhc, keep, mm_scg, mm_rhc, scg_out, rhc_out);
    Dev d;
    cudaMalloc(&d.scg, scg.size() * 4);
    cudaMalloc(&d.rhc, rhc.size() * 4);
    cudaMalloc(&d.scg_out, scg.size() * 4);
    cudaMalloc(&d.rhc_out, rhc.size() * 4);
    cudaMalloc(&d.mm_scg, 8 * n);
    cudaMalloc(&d.mm_rhc, 8 * n);
    cudaMalloc(&d.keep, n);
    cudaMemcpy(d.scg, scg.data(), scg.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(d.rhc, rhc.data(), rhc.size() * 4, cudaMemcpyHostToDevice);
    shape<32>(d, n, c, t, st, keep, mm_scg, mm_rhc, scg_out, rhc_out, cs.graph);
    shape<128>(d, n, c, t, st, keep, mm_scg, mm_rhc, scg_out, rhc_out, cs.graph);
    shape<256>(d, n, c, t, st, keep, mm_scg, mm_rhc, scg_out, rhc_out, cs.graph);
    shape<512>(d, n, c, t, st, keep, mm_scg, mm_rhc, scg_out, rhc_out, cs.graph);
    if (t == 750 && c * t <= 4 * 4 * 256)  // the copy kernel holds 4 float4 a thread
      printf("copy kernel N=%5d C=%d T=%5d: %.4f ms in a graph (256 threads a window)\n", n, c,
             t, graph_ms([&] {
               copy_kernel<<<n, 256, 0, st>>>(reinterpret_cast<const float4*>(d.scg), d.rhc,
                                              reinterpret_cast<float4*>(d.scg_out), d.rhc_out,
                                              c * t / 4, t);
             }, st));
    if (n == 300 && t == 750) {  // the flat scan's share: win = 1 runs no level of it
      const float scan = graph_ms([&] { run<256>(d, n, c, t, st); }, st);
      const float none = graph_ms([&] {
        gate::launch<256>(d.scg, d.rhc, d.scg_out, d.rhc_out, d.keep, d.mm_scg, d.mm_rhc, n, c, t,
                          1, kMinRhc, st);
      }, st);
      printf("256 threads N=%d T=%d in a graph: win = %d %.4f ms, win = 1 (no scan level) %.4f "
             "ms\n", n, t, kWin, scan, none);
    }
    for (void* p : {(void*)d.scg, (void*)d.rhc, (void*)d.scg_out, (void*)d.rhc_out,
                    (void*)d.mm_scg, (void*)d.mm_rhc, (void*)d.keep})
      cudaFree(p);
  }
  printf("gate_layouts: %d shape(s) with outputs that differ\n", failures);
  return failures ? 1 : 0;
}

// pixelrec_multimodal_tpu_torch/probes/csrc/vpu_roofline.cu
//
// Hopper probes P1 and P2: the float32 rates outside the tensor cores that
// bound the pair kernels' assemblies (probes/vpu_roofline.py times them).
//
// Replaces: scripts/profile_vpu_roofline.py:run_chain (P1, its
// fma_chain_kernel and exp_chain_kernel) and :measure_bcast's build (P2,
// bcast_mul_acc_kernel), Pallas probes of the TPU's vector unit.
//
// P1, chain_kernel: for every element of a [512, 128] f32 block, two
// interleaved chains of K / 2 steps each,
//   FMA: a = a*x + 1, b = b*x + 2 from a = x, b = x + 0.5, out = a + b;
//   EXP: a = a + exp(x - a*1e-6), b likewise from b = x*0.5, out = a + b,
// over a grid of `steps` passes of the same block (each pass writes the same
// out). One FMA step is one fused multiply-add instruction (FFMA, one
// rounding: __fmaf_rn), the unit the pair kernels' f32 work is counted in;
// one EXP step is the kernels' own expf (one MUFU.EX2 and its range
// reduction) beside an unfused multiply, subtract and add. Each thread runs
// 8 independent chains (4 elements of a float4 x 2), so the rate is
// throughput, not latency; the slope between two chain lengths (K 64 and
// 192) removes the loads, the stores and the launch.
//
// P2, bcast_kernel: weights w [TB, TC] times vectors v [TC, dp] accumulated
// into [TB, TC, dp]; each of the K - 1 later steps' weight is the
// accumulator's entry 0 times 1e-6 plus 1, so the loop cannot fold. The
// output is entry 0 alone, as the Pallas probe's is; the kernel also takes
// a pointer for the whole accumulator, written only when it is not null, so
// that the compiler cannot drop the other entries' work (the probe passes
// null). Laid out for the issue rate, not for K4's warps: BC_DP / E threads
// a (tb, tc) pair, E consecutive entries each, v's E entries in registers
// for the whole chain. Entry 0's recurrence depends only on itself and
// v[tc, 0], so every thread carries its own copy of it (two more
// multiply-adds a step; in the thread that owns entry 0 the copy equals
// its own entry) and no thread waits on another: no shuffle, no shared
// memory. E = 32: 34 multiply-adds a step for 32 entries, 79 to 96
// registers (the launch bounds cap them at 128; E = 64 would spill); the
// sweep (scripts/torch_profile_vpu_roofline.py) chose it over E = 16. The
// grid covers the card once and each block loops over its share of the
// `steps` passes, its inputs in registers throughout (each pass starts
// again from them, behind an opaque register copy of w, so no pass is
// folded into another). The slope between two chain lengths is a rate only
// if a pass's fixed cost adds to its chain: a block launched per pass, or
// loads in every pass, set a floor (about 1.1 ms over 8,192 passes on an
// H100) that hides a K 16 chain but not a K 48 one.
// FUSED issues each multiply-add as one FFMA (__fmaf_rn), the unit the
// data-sheet bound counts; FUSED = false issues K4's unfused pattern, a
// __fmul_rn then a __fadd_rn in attn::f2_add_mul's order, which rounds where
// the plain version does (bit for bit) and gives the rate K4's assembly can
// reach while it keeps that rounding order.
//
// Bound: both are bound by the instructions they issue (no bytes move but
// the block, read once per pass): P1 FMA at the FFMA rate (128 a cycle on
// each SM), P1 EXP at the MUFU rate (16 a cycle), P2 fused at the FFMA rate
// (E + 2 FFMAs a step for E entries), P2 unfused at the FMUL/FADD rate (two
// instructions a multiply-add).

#include <algorithm>

#include "attention_common.cuh"

namespace {

constexpr int CHAIN_THREADS = 256;
constexpr int EPT = 4;  // elements per thread: one float4

template <bool EXP>
__global__ void __launch_bounds__(CHAIN_THREADS)
chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
             int half_k) {
  const int i = (blockIdx.x * CHAIN_THREADS + threadIdx.x) * EPT;
  if (i >= n) return;
  const float4 xv = __ldg(reinterpret_cast<const float4*>(x + i));
  const float xs[EPT] = {xv.x, xv.y, xv.z, xv.w};
  float a[EPT], b[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    a[e] = xs[e];
    b[e] = EXP ? __fmul_rn(xs[e], 0.5f) : __fadd_rn(xs[e], 0.5f);
  }
  // Unrolled so that the loop's own compare and branch are a small share
  // of the issued instructions (the slope counts them with the steps).
#pragma unroll 16
  for (int k = 0; k < half_k; ++k) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if constexpr (EXP) {
        a[e] = __fadd_rn(a[e], expf(__fsub_rn(xs[e], __fmul_rn(a[e], 1e-6f))));
        b[e] = __fadd_rn(b[e], expf(__fsub_rn(xs[e], __fmul_rn(b[e], 1e-6f))));
      } else {
        a[e] = __fmaf_rn(a[e], xs[e], 1.f);
        b[e] = __fmaf_rn(b[e], xs[e], 2.f);
      }
    }
  }
  *reinterpret_cast<float4*>(out + i) =
      make_float4(__fadd_rn(a[0], b[0]), __fadd_rn(a[1], b[1]),
                  __fadd_rn(a[2], b[2]), __fadd_rn(a[3], b[3]));
}

constexpr int BC_DP = 128;        // the vectors' width
constexpr int BC_THREADS = 128;

// y + s*v: one FFMA, or K4's unfused product then sum.
template <bool FUSED>
__device__ __forceinline__ float bc_mul_add(float y, float s, float v) {
  return FUSED ? __fmaf_rn(s, v, y) : __fadd_rn(y, __fmul_rn(s, v));
}

template <bool FUSED, int E>
__global__ void __launch_bounds__(BC_THREADS, 4)
bcast_kernel(const float* __restrict__ w, const float* __restrict__ v,
             float* __restrict__ out, float* __restrict__ acc_out,
             int n_pairs, int TC, int K, int steps) {
  constexpr int TPP = BC_DP / E;  // threads a pair
  static_assert(BC_DP % E == 0 && E % 4 == 0 && BC_THREADS % TPP == 0,
                "E must divide the width in float4s");
  const int pair = blockIdx.x * (BC_THREADS / TPP) + threadIdx.x / TPP;
  const int q = threadIdx.x % TPP;
  if (pair >= n_pairs) return;
  const float* row = v + (size_t)(pair % TC) * BC_DP;
  // The block's inputs stay in registers across its passes, as the Pallas
  // block stays in VMEM across the grid's steps.
  float vv[E];
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row + q * E) + j);
    vv[4 * j] = t.x;
    vv[4 * j + 1] = t.y;
    vv[4 * j + 2] = t.z;
    vv[4 * j + 3] = t.w;
  }
  const float v0 = __ldg(row);
  const float w_pair = __ldg(w + pair);
  for (int pass = blockIdx.y; pass < steps; pass += gridDim.y) {
    float wt = w_pair;
    asm volatile("" : "+f"(wt));  // opaque: every pass computes anew
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(wt, vv[e]);
    float e0 = __fmul_rn(wt, v0);  // this thread's copy of entry 0
#pragma unroll 2
    for (int k = 1; k < K; ++k) {
      const float s = FUSED ? __fmaf_rn(e0, 1e-6f, 1.f)
                            : __fadd_rn(__fmul_rn(e0, 1e-6f), 1.f);
      e0 = bc_mul_add<FUSED>(e0, s, v0);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = bc_mul_add<FUSED>(acc[e], s, vv[e]);
    }
    if (q == 0) out[pair] = acc[0];
    if (acc_out != nullptr) {
      float4* dst =
          reinterpret_cast<float4*>(acc_out + (size_t)pair * BC_DP + q * E);
#pragma unroll
      for (int j = 0; j < E / 4; ++j)
        dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                             acc[4 * j + 3]);
    }
  }
}

// The grid covers the card once: as many blocks as fit on every SM at
// once, each looping over its share of the passes, so that a pass costs no
// block launch (the Pallas grid's sequential passes become a loop).
template <bool FUSED, int E>
cudaError_t launch_bcast(const float* w, const float* v, float* out,
                         float* acc_out, int n_pairs, int TC, int K,
                         int steps, cudaStream_t s) {
  constexpr int pairs_per_block = BC_THREADS / (BC_DP / E);
  const int gx = (n_pairs + pairs_per_block - 1) / pairs_per_block;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bcast_kernel<FUSED, E>, BC_THREADS, 0);
  if (err != cudaSuccess) return err;
  const int gy = std::max(1, std::min(steps, per_sm * sms / gx));
  bcast_kernel<FUSED, E><<<dim3(gx, gy), BC_THREADS, 0, s>>>(
      w, v, out, acc_out, n_pairs, TC, K, steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// P1: out[n] (f32) from x[n] (f32, 16-byte aligned, n a multiple of 4),
// chains of K steps (K even), the FMA chain (exp == 0) or the EXP chain,
// over `steps` passes of the block. Returns cudaSuccess or the first CUDA
// error (launch included).
int vpu_chain_forward(const void* x, void* out, int n, int K, int exp,
                      int steps, void* stream) {
  if (n <= 0 || n % EPT || K < 2 || K % 2 || steps < 1 || steps > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((n / EPT + CHAIN_THREADS - 1) / CHAIN_THREADS, steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (exp)
    chain_kernel<true><<<grid, CHAIN_THREADS, 0, s>>>(xf, o, n, K / 2);
  else
    chain_kernel<false><<<grid, CHAIN_THREADS, 0, s>>>(xf, o, n, K / 2);
  return cudaGetLastError();
}

// P2: out[TB, TC] (f32) from w [TB, TC] and v [TC, 128] (f32, 16-byte
// aligned), K >= 1 steps, over `steps` passes, fused (one FFMA a
// multiply-add) or not (K4's FMUL then FADD); `entries` a thread (16 or 32,
// the sweep's choices); acc_out, when not null, receives the whole
// accumulator [TB, TC, 128]. Returns cudaSuccess or the first CUDA error
// (launch included).
int vpu_bcast_forward(const void* w, const void* v, void* out, void* acc_out,
                      int TB, int TC, int K, int steps, int fused,
                      int entries, void* stream) {
  if (TB < 1 || TC < 1 || K < 1 || steps < 1 ||
      (entries != 16 && entries != 32))
    return cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  float* a = static_cast<float*>(acc_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = TB * TC;
  if (entries == 32)
    return fused ? launch_bcast<true, 32>(wf, vf, o, a, n, TC, K, steps, s)
                 : launch_bcast<false, 32>(wf, vf, o, a, n, TC, K, steps, s);
  return fused ? launch_bcast<true, 16>(wf, vf, o, a, n, TC, K, steps, s)
               : launch_bcast<false, 16>(wf, vf, o, a, n, TC, K, steps, s);
}

}  // extern "C"

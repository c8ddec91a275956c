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
// accumulator's entry 0 times 1e-6 plus 1, so the loop cannot fold. It is
// laid out the way K4's assembly is (attention_mlp.cu): one warp per
// (tb, tc) pair, dp = 128 across the lanes as two float2 slots each, every
// step K4's unfused f2_add_mul (a multiply and an add per entry, each
// rounded, attention_common.cuh), the step's weight a shuffle from lane 0.
// Its rate is the rate of K4's weighted sums of d-wide rows. The output is
// entry 0 alone, as the Pallas probe's is; the kernel also takes a pointer
// for the whole accumulator, written only when it is not null, so that the
// compiler cannot drop the other entries' work (the probe passes null).
//
// Bound: both are bound by the instructions they issue (no bytes move but
// the block, read once per pass): P1 FMA at the FFMA rate (128 a cycle on
// each SM), P1 EXP at the MUFU rate (16 a cycle), P2 at the FMUL/FADD rate
// plus a shuffle and two instructions per warp and step.

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

constexpr int BC_DP = 128;          // the vectors' width
constexpr int BC_J = BC_DP / 64;    // float2 slots per lane
constexpr int BC_WARPS = 16;

__global__ void __launch_bounds__(BC_WARPS * 32)
bcast_kernel(const float* __restrict__ w, const float* __restrict__ v,
             float* __restrict__ out, float* __restrict__ acc_out,
             int n_pairs, int TC, int K) {
  const int pair = blockIdx.x * BC_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;
  const int tc = pair % TC;
  const float wt = __ldg(w + pair);
  float2 vv[BC_J], acc[BC_J];
#pragma unroll
  for (int j = 0; j < BC_J; ++j) {
    vv[j] = __ldg(reinterpret_cast<const float2*>(v + (size_t)tc * BC_DP) +
                  lane + 32 * j);
    acc[j] = make_float2(__fmul_rn(wt, vv[j].x), __fmul_rn(wt, vv[j].y));
  }
  for (int k = 1; k < K; ++k) {
    const float s =
        __fadd_rn(__fmul_rn(__shfl_sync(attn::FULL, acc[0].x, 0), 1e-6f), 1.f);
#pragma unroll
    for (int j = 0; j < BC_J; ++j) acc[j] = attn::f2_add_mul(acc[j], s, vv[j]);
  }
  if (lane == 0) out[pair] = acc[0].x;
  if (acc_out != nullptr) {
#pragma unroll
    for (int j = 0; j < BC_J; ++j)
      reinterpret_cast<float2*>(acc_out + (size_t)pair * BC_DP)[lane + 32 * j] =
          acc[j];
  }
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

// P2: out[TB, TC] (f32) from w [TB, TC] and v [TC, 128] (f32, 8-byte
// aligned rows), K >= 1 steps, over `steps` passes; acc_out, when not null,
// receives the whole accumulator [TB, TC, 128]. Returns cudaSuccess or the
// first CUDA error (launch included).
int vpu_bcast_forward(const void* w, const void* v, void* out, void* acc_out,
                      int TB, int TC, int K, int steps, void* stream) {
  if (TB < 1 || TC < 1 || K < 1 || steps < 1 || steps > 65535)
    return cudaErrorInvalidValue;
  const int n_pairs = TB * TC;
  const dim3 grid((n_pairs + BC_WARPS - 1) / BC_WARPS, steps);
  bcast_kernel<<<grid, BC_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(acc_out), n_pairs, TC,
      K);
  return cudaGetLastError();
}

}  // extern "C"

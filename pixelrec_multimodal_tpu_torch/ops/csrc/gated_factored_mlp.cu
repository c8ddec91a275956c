// pixelrec_multimodal_tpu_torch/ops/csrc/gated_factored_mlp.cu
//
// Fused gated-fusion pair scoring for Hopper (sm_90a), factored variant:
// one launch scores a [B users] x [C items] block from the per-side
// factored gate coefficients and the per-item exp-scaled tables, through
// the BatchNorm-folded chain, and writes the [B, C] f32 score matrix.
//
// Replaces: pixelrec_multimodal_tpu/ops/pairwise_mlp.py:_gated_factored_kernel
// (bf16 mode, reached through pallas_pairwise_scores_gated_factored), and, as
// gated_factored_mlp_int8_forward, the same kernel's int8 mode (n_quant > 0:
// K3q).
//
// What it computes, per (user b, item c) pair, with M = n_mod modalities and
// Mi = M - 1 (ops/pairwise_mlp.py, factored form of the gated softmax):
//   Z   = sum_{m<M} a[b, m] * igb[c, m]    f32, from the unrounded a and b
//   p0  = a[b, 0] * igb[c, 0]
//   r   = sum_{m=1..Mi} bf16(a[b, m]) * T[c, m-1, :]    bf16 x bf16 products,
//         f32 sums (the TPU kernel's small-K MXU contraction)
//   x   = bf16(act((p0 * uf[b] + r) * (1 / max(Z, 1e-30))))
// then the shared chain of mlp_chain.cuh. T is the item-major table
// [C, Mi, h1] bf16 (factor_gated_tables), igb [C, GATE_PAD] f32 and a
// [B, GATE_PAD] f32, zero in their padding slots. The module's
// pairwise_scores_gated_factored_plain(compute_dtype=bfloat16) repeats
// these rounding points on tensors.
//
// Bound: per pair at the flagship head (h1 512, M = 6) the hidden products
// are 327,680 tensor-core operations; the assembly is about
// 2*Mi*h1 + 4*h1 + 2*M = 7,180 f32 operations (the contraction, the
// user term, the 1/Z scale, the activation) and the last dot 2*128. The
// tensor-core work is the larger at the data-sheet rates, and the bytes
// (per-user rows, per-item bf16 tables read once) are far below both: the
// kernel is bound by tensor-core operations.
//
// Design: K1's block shape and the shared chain. On the TPU the point of
// the factored form was to move the assembly onto the matrix unit; here the
// contraction has K = Mi <= 7 and is written as multiplies and adds on the
// CUDA cores, which cost no more than the exact kernel's weighted sum. What the factored form saves
// on this card is bytes: the item tables are bf16, half of the exact
// kernel's f32 parts, and the per-pair softmax becomes a Mi-term dot
// product. Each thread loads the Mi 4-column bf16 slots of one item once
// (8 bytes each) and combines them with all 8 users of the tile. The
// tile's f32 user rows, its bf16-rounded coefficients and the per-pair
// (p0, 1/Z) live in the weight ring until the chain starts. Every product
// and sum of the assembly is unfused (__fmul_rn, __fadd_rn) and in the
// plain version's order, so that both round the same f32 values to bf16.
//
// int8 mode (K3q, the template flag Q): the same assembly, each bf16
// activation then quantized with layer 0's (inv_a, off) into an int8 code,
// and the int8 chain of mlp_chain_int8.cuh; like K2q, bound by its f32
// operations rather than its int8 products.

#include "mlp_chain_int8.cuh"

namespace {

using namespace pairwise;

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 v) {
  const float2 lo = __bfloat1622float2(as_bf162(v.x));
  const float2 hi = __bfloat1622float2(as_bf162(v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <bool Q, int TB>
__global__ void __launch_bounds__(THREADS)
gated_factored_kernel(const float* __restrict__ uf, const float* __restrict__ a,
                      const __nv_bfloat16* __restrict__ T,
                      const float* __restrict__ igb,
                      const Weight<Q>* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ w_last,
                      const float* __restrict__ b_last,
                      float* __restrict__ out, int B, int C, int n_mod,
                      Chain ch, int act, int fin) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);

  constexpr int ROWS = Tile<TB>::ROWS;
  const int c0 = blockIdx.x * TC, u0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const int h1 = ch.width[0];
  const int q = h1 / 4;
  const int n_item = n_mod - 1;

  // Scratch in the ring: the tile's f32 user rows, their bf16-rounded
  // coefficients (as f32) and each pair row's (p0, 1/Z). Rows past B or C
  // have zero coefficients or tables, assemble to zeros and are never
  // written out.
  float* users = reinterpret_cast<float*>(scratch_of<Q, TB>(smem, ch));  // [TB, h1]
  float* coef = users + TB * h1;                             // [TB, GATE_PAD]
  float2* row_z = reinterpret_cast<float2*>(coef + TB * GATE_PAD);  // [ROWS]
  for (int e = tid; e < TB * q; e += THREADS) {
    const int bu = e / q, k = (e - bu * q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + bu < B)
      v = __ldg(reinterpret_cast<const float4*>(uf + (size_t)(u0 + bu) * h1 + k));
    *reinterpret_cast<float4*>(users + bu * h1 + k) = v;
  }
  for (int e = tid; e < TB * GATE_PAD; e += THREADS) {
    const int bu = e / GATE_PAD, m = e % GATE_PAD;
    coef[e] = (u0 + bu < B && m < n_mod)
                  ? __bfloat162float(__float2bfloat16_rn(
                        a[(size_t)(u0 + bu) * GATE_PAD + m]))
                  : 0.f;
  }
  for (int r = tid; r < ROWS; r += THREADS) {
    const int u = u0 + r / TC, c = c0 + r % TC;
    float z = 0.f, p0 = 0.f;
#pragma unroll
    for (int m = 0; m < GATE_PAD; ++m)
      if (m < n_mod) {
        const float p = __fmul_rn(u < B ? a[(size_t)u * GATE_PAD + m] : 0.f,
                                  c < C ? igb[(size_t)c * GATE_PAD + m] : 0.f);
        if (m == 0) p0 = p;
        z = m == 0 ? p : __fadd_rn(z, p);
      }
    row_z[r] = make_float2(p0, 1.f / fmaxf(z, 1e-30f));
  }
  // int8 mode: layer 0's (inv_a, off), bias[0] and bias[1]
  float inv_a = 0.f, off = 0.f;
  if constexpr (Q) {
    inv_a = bias[0];
    off = bias[1];
  }
  __syncthreads();

  // ---- assembly: buf_a[bu * TC + ci] = bf16(act((p0 * u + r) / Z))
  // (int8 mode: its codes).
  for (int e = tid; e < TC * q; e += THREADS) {
    const int ci = e / q, k = (e - ci * q) * 4;
    float4 t[GATE_PAD - 1];
#pragma unroll
    for (int m = 0; m < GATE_PAD - 1; ++m) {
      uint2 v = make_uint2(0u, 0u);
      if (m < n_item && c0 + ci < C)
        v = __ldg(reinterpret_cast<const uint2*>(
            T + ((size_t)(c0 + ci) * n_item + m) * h1 + k));
      t[m] = bf16x4_to_float4(v);
    }
#pragma unroll
    for (int bu = 0; bu < TB; ++bu) {
      const int r = bu * TC + ci;
      const float* cf = coef + bu * GATE_PAD;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int m = 0; m < GATE_PAD - 1; ++m)
        if (m < n_item) {
          const float am = cf[m + 1];
          acc.x = __fadd_rn(acc.x, __fmul_rn(am, t[m].x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(am, t[m].y));
          acc.z = __fadd_rn(acc.z, __fmul_rn(am, t[m].z));
          acc.w = __fadd_rn(acc.w, __fmul_rn(am, t[m].w));
        }
      const float2 pz = row_z[r];
      const float4 u = *reinterpret_cast<const float4*>(users + bu * h1 + k);
      const float4 x = make_float4(
          __fmul_rn(__fadd_rn(__fmul_rn(pz.x, u.x), acc.x), pz.y),
          __fmul_rn(__fadd_rn(__fmul_rn(pz.x, u.y), acc.y), pz.y),
          __fmul_rn(__fadd_rn(__fmul_rn(pz.x, u.z), acc.z), pz.y),
          __fmul_rn(__fadd_rn(__fmul_rn(pz.x, u.w), acc.w), pz.y));
      if constexpr (Q) {
        *reinterpret_cast<uint32_t*>(smem + r * ch.stride_a + k) =
            quantize_bf16x4(act_to_bf16x4(x, act), inv_a, off);
      } else {
        *reinterpret_cast<uint2*>(buf_a + r * ch.stride_a + k) =
            act_to_bf16x4(x, act);
      }
    }
  }
  __syncthreads();
  if constexpr (Q) {
    run_chain_int8<TB>(smem, w, bias, w_last, b_last, out, B, C, u0, c0, ch,
                       act, fin);
  } else {
    run_chain<TB>(buf_a, w, bias, w_last, b_last, out, B, C, u0, c0, ch, act,
                  fin);
  }
}

// The assembly's scratch in the ring (see the kernel).
inline size_t scratch_bytes(const Chain& ch, int rows) {
  return ((size_t)(rows / TC) * (ch.width[0] + GATE_PAD) + 2 * (size_t)rows) * 4;
}

template <bool Q>
int forward(const void* uf, const void* a, const void* T, const void* igb,
            const void* w, const void* bias, const void* w_last,
            const void* b_last, void* out, int B, int C, int n_hidden,
            const void* widths, int act, int fin, int n_mod, int rows,
            void* stream) {
  if (n_mod < 2 || n_mod > GATE_PAD) return cudaErrorInvalidValue;
  Chain ch;
  cudaError_t err = make_chain_of<Q>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_of<Q>(ch, scratch_bytes(ch, rows), rows);
  return dispatch_rows(rows, [&](auto tb) {
    constexpr int TB = decltype(tb)::value;
    dim3 grid;
    cudaError_t e = prepare_launch(gated_factored_kernel<Q, TB>, smem, B, C, rows, &grid);
    if (e != cudaSuccess) return e;
    gated_factored_kernel<Q, TB><<<grid, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(uf), static_cast<const float*>(a),
        static_cast<const __nv_bfloat16*>(T), static_cast<const float*>(igb),
        static_cast<const Weight<Q>*>(w), static_cast<const float*>(bias),
        static_cast<const float*>(w_last), static_cast<const float*>(b_last),
        static_cast<float*>(out), B, C, n_mod, ch, act, fin);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from user_first [B, h1] and the user
// coefficients a [B, GATE_PAD] (f32, 16-byte aligned rows), the item
// tables T [C, Mi, h1] (bf16, 8-byte aligned) and igb [C, GATE_PAD] (f32);
// only the first n_mod coefficient columns are read (2 <= n_mod <=
// GATE_PAD, Mi = n_mod - 1). The chain arguments (w, bias, w_last, b_last,
// n_hidden, widths, act, fin) are pairwise_mlp_forward's. Returns
// cudaSuccess or the first CUDA error (launch included); a width that does
// not fit in shared memory returns cudaErrorInvalidValue; rows is the
// block's pair rows (128, 64, 32 or 16: ops/pairwise_mlp.py:block_rows).
int gated_factored_mlp_forward(const void* uf, const void* a, const void* T,
                               const void* igb, const void* w,
                               const void* bias, const void* w_last,
                               const void* b_last, void* out, int B, int C,
                               int n_hidden, const void* widths, int act,
                               int fin, int n_mod, int rows, void* stream) {
  return forward<false>(uf, a, T, igb, w, bias, w_last, b_last, out, B, C,
                        n_hidden, widths, act, fin, n_mod, rows, stream);
}

// The int8 mode (K3q): the arguments of gated_factored_mlp_forward, with the
// chain arguments of pairwise_mlp_int8_forward.
int gated_factored_mlp_int8_forward(const void* uf, const void* a,
                                    const void* T, const void* igb,
                                    const void* w, const void* bias,
                                    const void* w_last, const void* b_last,
                                    void* out, int B, int C, int n_hidden,
                                    const void* widths, int act, int fin,
                                    int n_mod, int rows, void* stream) {
  return forward<true>(uf, a, T, igb, w, bias, w_last, b_last, out, B, C,
                       n_hidden, widths, act, fin, n_mod, rows, stream);
}

// Shared memory a block of `rows` pair rows takes in either mode (int8 != 0),
// as the launch set-up counts it; a negative CUDA error for widths the kernel
// does not take.
int gated_factored_mlp_block_bytes(int n_hidden, const void* widths, int int8, int rows) {
  Chain ch;
  const cudaError_t err = int8 ? make_chain_of<true>(n_hidden, widths, rows, &ch)
                               : make_chain_of<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  const size_t scratch = scratch_bytes(ch, rows);
  return (int)(int8 ? smem_of<true>(ch, scratch, rows)
                    : smem_of<false>(ch, scratch, rows));
}

}  // extern "C"

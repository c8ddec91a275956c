// pixelrec_multimodal_tpu_torch/ops/csrc/attention_screen_mlp.cu
//
// The attention cascade's token-0 screen for Hopper (sm_90a), kernel K6: one
// launch scores a [B users] x [C items] block with the user token's
// attention row computed exactly and the item tokens frozen to their
// item-only limit, whose LayerNormed sum is a per-item table (the tail,
// ops/attention_cascade.py:compute_screen_tail), then the BatchNorm-folded
// MLP, and writes the [B, C] f32 score matrix.
//
// Replaces: pixelrec_multimodal_tpu/ops/attention_cascade.py:
// _attention_screen_kernel (reached through pallas_attention_screen_scores).
//
// What it computes, per (user b, item c) pair, with T = 1 + Mi tokens and H
// heads, in f32 (ops/attention_cascade.py:attention_screen_scores_plain
// repeats it operation for operation):
//   per head: w = softmax(suu, q_b . k_cm for m < Mi)
//   y_0   = raw_b + sum_h (w_0h vo_bh + sum_m w_mh vo_cmh)
//   fused = LN(y_0) / T * gamma + (beta + tail_c)   (LN: centred, eps 1e-6)
//   x     = bf16(fused), then the chain of mlp_chain.cuh from w1 on.
// It reads the item keys k and values vo and the tail: not raw, q, sexp or
// dm.
//
// Bound: per pair at the flagship head (d 64 -> 512 -> 256 -> 128 -> 1, H 4,
// Mi 5) the chain is 393,216 tensor-core operations, as in K4; the assembly
// is about 4.4k f32 operations (the 20 logit dots over dh, token 0's softmax
// per head, its weighted sum over d, one LayerNorm, the affine and the tail)
// and the last dot 2*128. At the data-sheet rates (989 TFLOP/s bf16 tensor,
// 67 TFLOP/s f32) the tensor-core work takes the longer, so the kernel is
// bound by tensor-core operations; the bytes (each table row read once) are
// far below either.
//
// Design: K4 without the item tokens, with the tail added. The block, the 16
// warps and the chain are K4's (8 users x 16 items; 4, 2 or 1 users for
// wider heads): the wgmma chain of mlp_chain_wgmma.cuh at 128 and 64 rows
// (229,440 B of shared memory at the flagship widths: buffers of 64 and 512
// swizzled columns and five 16 KB ring stages; d 512 at the flagship chain:
// 64 rows, one 512-column buffer, 196,672 B) and the mma.sync chain of
// mlp_chain.cuh at 32 and 16. The tile's user rows and token 0's
// coefficients (H * (Mi + 1) per pair) live in buffer B until the chain's
// layer 0 writes it. Logits and softmax are
// attention_common.cuh's token-0 halves, the assembly K4's token-0 loop (one
// warp per item, its Mi * H vo rows streamed from global memory and combined
// with the tile's users),
// then one LayerNorm per pair and the affine with the item's tail folded into
// beta, and the one bf16 rounding into buf_a (FusedRows: the wgmma chain's
// swizzled layout at 128 and 64 rows).

#include "attention_common.cuh"

namespace {

using namespace pairwise;
using namespace attn;

// The fused vectors of warp ci's TB pairs into buf_a (out), as bf16, UB
// users at a time.
template <int J, int TB, bool SW>
__device__ __forceinline__ void screen_assemble(
    const float* U, const float* coef, const Dims& D,
    const float* __restrict__ it_vo, const float* __restrict__ it_tail,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const FusedRows<TB, SW>& out, int c0, int C) {
  constexpr int UB = assembly_users<J, TB>();
  constexpr int R = row_buffers<J>() < MAX_ITEM_MODS ? 1 : MAX_ITEM_MODS;
  const int ci = threadIdx.x >> 5, c = c0 + ci;
  const int d = D.d, half = d / 2;
  if (c >= C) {
    zero_rows_at(out, ci, d);
    return;
  }
  const float inv_d = __fdiv_rn(1.f, (float)d);
  const float inv_t = __fdiv_rn(1.f, (float)(D.Mi + 1));
  const float2 zero = make_float2(0.f, 0.f);
  float2 rows[R][J];
  for (int b0 = 0; b0 < TB; b0 += UB) {
    float2 f[UB][J], y[UB][J];
#pragma unroll
    for (int bu = 0; bu < UB; ++bu)
#pragma unroll
      for (int j = 0; j < J; ++j) f[bu][j] = y[bu][j] = zero;

    token0_input<J, R, UB>(U, coef, D, it_vo, rows, y, c, ci, b0);
#pragma unroll
    for (int bu = 0; bu < UB; ++bu)
      layer_norm_add(y[bu], f[bu], half, inv_d, inv_t);

    // ---- the affine, beta + tail once per item, and the one bf16 rounding
    float2 g[J], be[J], tl[J];
    load_f2(g, ln_scale, half);
    load_f2(be, ln_bias, half);
    load_f2(tl, it_tail + (size_t)c * d, half);
#pragma unroll
    for (int j = 0; j < J; ++j)
      be[j] = make_float2(__fadd_rn(be[j].x, tl[j].x),
                          __fadd_rn(be[j].y, tl[j].y));
#pragma unroll
    for (int bu = 0; bu < UB; ++bu) {
      const int r = (b0 + bu) * TC + ci;
      store_fused_at(f[bu], g, be, [&](int k) { return out.at(r, k); }, half);
    }
  }
}

template <int J, int TB>
__global__ void __launch_bounds__(THREADS)
screen_kernel(const float* __restrict__ u_raw, const float* __restrict__ u_q,
              const float* __restrict__ u_k, const float* __restrict__ u_vo,
              const float* __restrict__ u_suu, const float* __restrict__ it_k,
              const float* __restrict__ it_vo,
              const float* __restrict__ it_tail,
              const float* __restrict__ ln_scale,
              const float* __restrict__ ln_bias,
              const __nv_bfloat16* __restrict__ w_sw,
              const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ bias, const float* __restrict__ w_last,
              const float* __restrict__ b_last, float* __restrict__ out, int B,
              int C, Dims D, WgChain ch, int act, int fin) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr bool SW = wgmma_rows<TB>();
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  int u0, c0;
  tile_origin<TB>(&u0, &c0);
  float* U = reinterpret_cast<float*>(buffer_b<TB>(buf_a, ch));
  float* coef = U + TB * D.urow;

  load_users<TB>(U, D, u_raw, u_q, u_k, u_vo, u_suu, nullptr, u0, B);
  __syncthreads();
  pair_logits<false, TB>(U, coef, D, nullptr, it_k, c0, C);
  __syncthreads();
  softmax_coefs<false, TB>(U, coef, D, nullptr, c0, C);
  __syncthreads();
  screen_assemble<J, TB>(U, coef, D, it_vo, it_tail, ln_scale, ln_bias,
                         FusedRows<TB, SW>{buf_a, ch.stride_a}, c0, C);
  __syncthreads();
  run_chain_of<TB>(buf_a, w, w_sw, bias, w_last, b_last, out, B, C, u0, c0,
                   ch, act, fin);
}

template <int J>
cudaError_t launch(const void* const* p, const void* w, const void* bias,
                   const void* w_last, const void* b_last, void* out, int B,
                   int C, const Dims& D, const WgChain& ch, int act, int fin,
                   int rows, cudaStream_t stream) {
  return dispatch_rows(rows, [&](auto tb) {
    constexpr int TB = decltype(tb)::value;
    dim3 grid;
    size_t smem = 0;
    cudaError_t err = prepare_attention(screen_kernel<J, TB>, ch, D, B, C,
                                        rows, &grid, &smem);
    if (err != cudaSuccess) return err;
    const float* const* f = reinterpret_cast<const float* const*>(p);
    screen_kernel<J, TB><<<grid, THREADS, smem, stream>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9],
        static_cast<const __nv_bfloat16*>(p[10]),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
        static_cast<const float*>(w_last), static_cast<const float*>(b_last),
        static_cast<float*>(out), B, C, D, ch, act, fin);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from the user rows u_raw, u_q, u_k
// [B, d], u_vo [B, H*d], u_suu [B, 8] and the item tables it_k [C, Mi*d],
// it_vo [C, Mi*H*d] and it_tail [C, d], with the LayerNorm affine ln_scale,
// ln_bias [d]; all f32, row-major, 16-byte aligned; then w_sw, the hidden
// weights packed for the wgmma chain (read at 128 and 64 rows, w below).
// The chain arguments are attention_mlp_forward's (widths[0] = d, w1 as
// layer 0, rows the block's pair rows). Returns cudaSuccess or the first
// CUDA error (launch included); shapes the kernel does not take, or a
// block that does not fit in shared memory, return cudaErrorInvalidValue.
int attention_screen_mlp_forward(
    const void* u_raw, const void* u_q, const void* u_k, const void* u_vo,
    const void* u_suu, const void* it_k, const void* it_vo,
    const void* it_tail, const void* ln_scale, const void* ln_bias,
    const void* w_sw, const void* w, const void* bias, const void* w_last,
    const void* b_last, void* out, int B, int C, int n_hidden,
    const void* widths, int act, int fin, int H, int Mi, int rows,
    void* stream) {
  WgChain ch;
  cudaError_t err = make_chain_for(rows, n_hidden,
                                   static_cast<const int*>(widths), &ch);
  if (err != cudaSuccess) return err;
  Dims D;
  err = make_dims(ch.width[0], H, Mi, false, &D, false);
  if (err != cudaSuccess) return err;
  const void* p[11] = {u_raw, u_q,     u_k,     u_vo,     u_suu, it_k,
                       it_vo, it_tail, ln_scale, ln_bias, w_sw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slots_per_lane(D.d)) {
    case 1:
      return launch<1>(p, w, bias, w_last, b_last, out, B, C, D, ch, act, fin,
                       rows, s);
    case 2:
      return launch<2>(p, w, bias, w_last, b_last, out, B, C, D, ch, act, fin,
                       rows, s);
    case 4:
      return launch<4>(p, w, bias, w_last, b_last, out, B, C, D, ch, act, fin,
                       rows, s);
    default:
      return launch<8>(p, w, bias, w_last, b_last, out, B, C, D, ch, act, fin,
                       rows, s);
  }
}

// Shared memory a block of `rows` pair rows takes, as the launch set-up
// counts it; a negative CUDA error for shapes the kernel does not take.
int attention_screen_mlp_block_bytes(int n_hidden, const void* widths, int H,
                                     int Mi, int rows) {
  if (!valid_rows(rows)) return -(int)cudaErrorInvalidValue;
  WgChain ch;
  cudaError_t err = make_chain_for(rows, n_hidden,
                                   static_cast<const int*>(widths), &ch);
  if (err == cudaSuccess) {
    Dims D;
    err = make_dims(ch.width[0], H, Mi, false, &D, false);
    if (err == cudaSuccess) return (int)attention_smem_bytes(ch, D, rows);
  }
  return -(int)err;
}

// The chain a block of `rows` pair rows runs: 2 wgmma, 1 mma.sync.
int attention_screen_mlp_chain_kind(int rows) { return chain_kind(rows); }

}  // extern "C"

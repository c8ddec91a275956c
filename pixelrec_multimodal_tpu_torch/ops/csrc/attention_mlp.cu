// pixelrec_multimodal_tpu_torch/ops/csrc/attention_mlp.cu
//
// Fused attention-fusion pair scoring for Hopper (sm_90a), stream form
// (kernel K4): one launch scores a [B users] x [C items] block through the
// attention layer's per-side tables, LayerNorm, the token mean and the
// BatchNorm-folded MLP, and writes the [B, C] f32 score matrix.
//
// Replaces: pixelrec_multimodal_tpu/ops/attention_scorer.py:_attention_kernel
// (reached through pallas_attention_scores, variant 'stream').
//
// What it computes, per (user b, item c) pair, with T = 1 + Mi tokens and H
// heads, in f32 (ops/attention_scorer.py:attention_scores_plain repeats it
// operation for operation):
//   token 0 (the user), per head: w = softmax(suu, q_b . k_cm for m < Mi)
//        y_0 = raw_b + sum_h (w_0h vo_bh + sum_m w_mh vo_cmh)
//   item token t, per head: e_u = exp(min(q_ct . k_b - mx_cth, 80)),
//        r = 1 / (e_u + dsum_cth), a = e_u r, b = r
//        y_t = raw_ct + sum_h (a_th vo_bh + b_th sexp_cth)
//   fused = gamma * sum_t LN(y_t) / T + beta   (LN: centred, eps 1e-6)
//   x     = bf16(fused), then the chain of mlp_chain.cuh from w1 on:
//           bf16(act(bf16(x @ w1 + bf16(b1)))), the hidden layers, the dot.
// b_out is folded into raw; vo is the value row times the head's block of
// W_out; sexp and (dsum, mx) are the item keys' softmax mass of item query
// t, built once per catalog.
//
// Bound: per pair at the flagship head (d 64 -> 512 -> 256 -> 128 -> 1, H 4,
// Mi 5) the chain is 2*64*512 + 2*512*256 + 2*256*128 = 393,216 tensor-core
// operations; the assembly is about 12k f32 operations (the 40 logit dots
// over dh, 44 exps, the weighted sums over d per token, 6 LayerNorms) and
// the last dot 2*128. At the data-sheet rates (989 TFLOP/s bf16 tensor, 67
// TFLOP/s f32) the tensor-core work takes the longer, so the kernel is
// bound by tensor-core operations; the bytes (each table row read once) are
// far below either.
//
// Design: the block is K1's (8 users x 16 items, 16 warps, two activation
// buffers and a weight ring), the chain the wgmma chain of
// mlp_chain_wgmma.cuh at 128 and 64 rows (229,440 B of shared memory at the
// flagship widths: buffers of 64 and 512 swizzled columns, w1's 512 outputs
// in B and the later layers over them, and a ring of five 16 KB stages) and
// K1's mma.sync chain at 32 and 16. The tile's user rows
// (15.5 KB) and the per-pair
// coefficients (33 KB) fit in buffer B, which the chain first writes in its
// layer 0; the 16 items' tables (228 KB) do not, and stream from global
// memory: one warp per item, lanes across d (a float2 each), each item row
// read once and combined with the tile's 8 users (a head's or a token's
// rows loaded together), warp butterflies for the LayerNorm sums. The
// logits are dot products per thread, the softmax one thread per (pair,
// head). The grid runs the user tiles of an item tile
// together, so an item tile is read from HBM once and from L2 after. A
// wider head takes a block of 4, 2 or 1 users (d 512 at the flagship chain:
// 4 users, 196,672 B, every layer over its input in one 512-column
// buffer), and at d past 256 the assembly holds two users' vectors
// at a time and reads each item row once per pair of users
// (attention_common.cuh).

#include "attention_common.cuh"

namespace {

using namespace pairwise;
using namespace attn;

// The fused vectors of warp ci's TB pairs into buf_a (out), as bf16, UB
// users at a time.
template <int J, int TB, bool SW>
__device__ __forceinline__ void stream_assemble(
    const float* U, const float* coef, const Dims& D,
    const float* __restrict__ it_raw, const float* __restrict__ it_vo,
    const float* __restrict__ it_sexp, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const FusedRows<TB, SW>& out, int c0,
    int C) {
  constexpr int UB = assembly_users<J, TB>(), R = row_buffers<J>();
  constexpr bool AHEAD = R >= MAX_HEADS;
  const int ci = threadIdx.x >> 5, c = c0 + ci;
  const int d = D.d, H = D.H, Mi = D.Mi, half = d / 2;
  if (c >= C) {
    zero_rows_at(out, ci, d);
    return;
  }
  const float inv_d = __fdiv_rn(1.f, (float)d);
  const float inv_t = __fdiv_rn(1.f, (float)(Mi + 1));
  const float2 zero = make_float2(0.f, 0.f);
  float2 rows[R][J];
  for (int b0 = 0; b0 < TB; b0 += UB) {
    float2 f[UB][J], y[UB][J];
#pragma unroll
    for (int bu = 0; bu < UB; ++bu)
#pragma unroll
      for (int j = 0; j < J; ++j) f[bu][j] = y[bu][j] = zero;

    // ---- token 0 (attention_common.cuh), then its LayerNorm
    token0_input<J, R, UB>(U, coef, D, it_vo, rows, y, c, ci, b0);
#pragma unroll
    for (int bu = 0; bu < UB; ++bu)
      layer_norm_add(y[bu], f[bu], half, inv_d, inv_t);

    // ---- item tokens: y = raw_t + sum_h (a_th u_vo_h + b_th sexp_th), the
    // token's H sexp rows (with R row buffers) and its raw row loaded
    // together
    for (int t = 0; t < Mi; ++t) {
      float2 raw[J];
      load_f2(raw, it_raw + ((size_t)c * Mi + t) * d, half);
      if constexpr (AHEAD) {
#pragma unroll
        for (int h = 0; h < MAX_HEADS; ++h)
          if (h < H)
            load_f2(rows[h], it_sexp + (((size_t)c * Mi + t) * H + h) * d,
                    half);
      }
#pragma unroll
      for (int bu = 0; bu < UB; ++bu)
#pragma unroll
        for (int j = 0; j < J; ++j) y[bu][j] = zero;
#pragma unroll
      for (int h = 0; h < MAX_HEADS; ++h) {
        if (h >= H) break;
        if constexpr (!AHEAD)
          load_f2(rows[0], it_sexp + (((size_t)c * Mi + t) * H + h) * d, half);
        const float2 (&row)[J] = rows[AHEAD ? h : 0];
#pragma unroll
        for (int bu = 0; bu < UB; ++bu) {
          const float* cf =
              coef + ((b0 + bu) * TC + ci) * D.ncoef + ct_off(D, t, h);
          const float a = cf[0], b = cf[1];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            y[bu][j] =
                f2_add_mul(y[bu][j], a, user_vo(U, D, b0 + bu, h, j, half));
            y[bu][j] = f2_add_mul(y[bu][j], b, row[j]);
          }
        }
      }
#pragma unroll
      for (int bu = 0; bu < UB; ++bu) {
#pragma unroll
        for (int j = 0; j < J; ++j)
          y[bu][j] = make_float2(__fadd_rn(raw[j].x, y[bu][j].x),
                                 __fadd_rn(raw[j].y, y[bu][j].y));
        layer_norm_add(y[bu], f[bu], half, inv_d, inv_t);
      }
    }

    // ---- the LayerNorm affine, once, and the one bf16 rounding
    float2 g[J], be[J];
    load_f2(g, ln_scale, half);
    load_f2(be, ln_bias, half);
#pragma unroll
    for (int bu = 0; bu < UB; ++bu) {
      const int r = (b0 + bu) * TC + ci;
      store_fused_at(f[bu], g, be, [&](int k) { return out.at(r, k); }, half);
    }
  }
}

template <int J, int TB>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const float* __restrict__ u_raw, const float* __restrict__ u_q,
                 const float* __restrict__ u_k, const float* __restrict__ u_vo,
                 const float* __restrict__ u_suu,
                 const float* __restrict__ it_raw,
                 const float* __restrict__ it_q, const float* __restrict__ it_k,
                 const float* __restrict__ it_vo,
                 const float* __restrict__ it_sexp,
                 const float* __restrict__ it_dm,
                 const float* __restrict__ ln_scale,
                 const float* __restrict__ ln_bias,
                 const __nv_bfloat16* __restrict__ w_sw,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ w_last,
                 const float* __restrict__ b_last, float* __restrict__ out,
                 int B, int C, Dims D, WgChain ch, int act, int fin) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr bool SW = wgmma_rows<TB>();
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  int u0, c0;
  tile_origin<TB>(&u0, &c0);
  float* U = reinterpret_cast<float*>(buffer_b<TB>(buf_a, ch));
  float* coef = U + TB * D.urow;

  load_users<TB>(U, D, u_raw, u_q, u_k, u_vo, u_suu, nullptr, u0, B);
  __syncthreads();
  pair_logits<true, TB>(U, coef, D, it_q, it_k, c0, C);
  __syncthreads();
  softmax_coefs<true, TB>(U, coef, D, it_dm, c0, C);
  __syncthreads();
  stream_assemble<J, TB>(U, coef, D, it_raw, it_vo, it_sexp, ln_scale,
                         ln_bias, FusedRows<TB, SW>{buf_a, ch.stride_a}, c0,
                         C);
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
    cudaError_t err = prepare_attention(attention_kernel<J, TB>, ch, D, B, C,
                                        rows, &grid, &smem);
    if (err != cudaSuccess) return err;
    const float* const* f = reinterpret_cast<const float* const*>(p);
    attention_kernel<J, TB><<<grid, THREADS, smem, stream>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
        f[11], f[12], static_cast<const __nv_bfloat16*>(p[13]),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(w_last),
        static_cast<const float*>(b_last), static_cast<float*>(out), B, C, D,
        ch, act, fin);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from the user rows u_raw, u_q, u_k
// [B, d], u_vo [B, H*d], u_suu [B, 8] and the item tables it_raw, it_q,
// it_k [C, Mi*d], it_vo, it_sexp [C, Mi*H*d], it_dm [C, H*Mi*2], with the
// LayerNorm affine ln_scale, ln_bias [d]; all f32, row-major, 16-byte
// aligned; then w_sw, the hidden weights packed for the wgmma chain
// (mlp_chain_wgmma.cuh; read at 128 and 64 rows, w below). The chain
// arguments (w, bias, w_last, b_last, n_hidden, widths, act, fin, rows) are
// pairwise_mlp_forward's, with widths[0] = d and w1 as
// layer 0 (a chain with no hidden layer takes the last dot on the fused
// vector itself: the assembly alone, for measurements). Returns cudaSuccess
// or the first CUDA error (launch included); shapes the kernel does not
// take, or a block that does not fit in shared memory, return
// cudaErrorInvalidValue.
int attention_mlp_forward(const void* u_raw, const void* u_q, const void* u_k,
                          const void* u_vo, const void* u_suu,
                          const void* it_raw, const void* it_q,
                          const void* it_k, const void* it_vo,
                          const void* it_sexp, const void* it_dm,
                          const void* ln_scale, const void* ln_bias,
                          const void* w_sw, const void* w, const void* bias,
                          const void* w_last, const void* b_last, void* out,
                          int B, int C, int n_hidden, const void* widths,
                          int act, int fin, int H, int Mi, int rows,
                          void* stream) {
  WgChain ch;
  cudaError_t err = make_chain_for(rows, n_hidden,
                                   static_cast<const int*>(widths), &ch);
  if (err != cudaSuccess) return err;
  Dims D;
  err = make_dims(ch.width[0], H, Mi, false, &D);
  if (err != cudaSuccess) return err;
  const void* p[14] = {u_raw, u_q,     u_k,   u_vo,     u_suu,
                       it_raw, it_q,   it_k,  it_vo,    it_sexp,
                       it_dm,  ln_scale, ln_bias, w_sw};
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

// Shared memory a block of `rows` pair rows takes for these widths, heads
// and item tokens, as the launch set-up counts it; a negative CUDA error for
// shapes the kernel does not take.
int attention_mlp_block_bytes(int n_hidden, const void* widths, int H, int Mi,
                              int rows) {
  if (!valid_rows(rows)) return -(int)cudaErrorInvalidValue;
  WgChain ch;
  cudaError_t err = make_chain_for(rows, n_hidden,
                                   static_cast<const int*>(widths), &ch);
  if (err == cudaSuccess) {
    Dims D;
    err = make_dims(ch.width[0], H, Mi, false, &D);
    if (err == cudaSuccess) return (int)attention_smem_bytes(ch, D, rows);
  }
  return -(int)err;
}

// The chain a block of `rows` pair rows runs: 2 wgmma, 1 mma.sync.
int attention_mlp_chain_kind(int rows) { return chain_kind(rows); }

}  // extern "C"

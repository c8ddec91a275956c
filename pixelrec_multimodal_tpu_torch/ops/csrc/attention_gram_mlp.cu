// pixelrec_multimodal_tpu_torch/ops/csrc/attention_gram_mlp.cu
//
// Fused attention-fusion pair scoring for Hopper (sm_90a), gram form
// (kernel K5): the scores of attention_mlp.cu (K4), with each token's
// LayerNorm statistics taken from Grams instead of from the token's vector.
//
// Replaces:
// pixelrec_multimodal_tpu/ops/attention_scorer.py:_attention_gram_kernel
// (reached through _pallas_attention_scores_gram, pallas_attention_scores
// variant 'gram').
//
// What it computes, per (user b, item c) pair (the coefficients w, a, b are
// K4's, attention_common.cuh): each token's pre-LayerNorm vector is a
// combination of per-side components,
//   y_0 = raw_b + sum_h w_0h vo_bh + sum_mh w_mh vo_cmh
//   y_t = raw_ct + sum_h (a_th vo_bh + b_th sexp_cth),
// so its mean is the same combination of component means and its mean
// square a quadratic form over component Grams: user x user and item x item
// Grams come from the per-user and per-item scalar tables
// (ops/attention_scorer.py:user_sc_layout, gram_layout); the user x item
// cross-Grams <raw_b | vo_bh, vo_cmh | sexp_cth | raw_ct> are dot products
// over d per pair. Variance is E[y^2] - mu^2, clamped at 0. One pass over
// d then forms
//   fused = gamma (1/T) (sig_0 raw_b + sum_h wu_h vo_bh + sum_mh wv_mh vo_cmh
//                      + sum_t sig_t raw_ct - ones) + beta,
// with sig_t = 1/sqrt(var_t + 1e-6), wu_h = w_0h sig_0 + sum_t a_th sig_t,
// wv_mh = w_mh sig_0 + sum_t b_th sig_t e_tmh (sexp expanded over vo by the
// item-key exps e_ii) and ones = sum_t mu_t sig_t; then bf16 and K4's chain.
// ops/attention_scorer.py:attention_scores_gram_plain repeats it operation
// for operation.
//
// Bound: per pair at the flagship head (d 64, H 4, Mi 5) the cross-Grams
// are 200 dots over d (25,600 f32 operations), the statistics about 2,400
// and the combination pass about 3,600, ~36k with the logits and the
// softmax, against the chain's 393,216 tensor-core operations. At the
// data-sheet rates the f32 work takes the longer (0.54 us against 0.40 us
// per thousand pairs), so the kernel is bound by f32 operations. On the TPU
// the form moved vector work onto the matrix unit; here, in f32 outside the
// tensor cores, it does about three times K4's f32 work.
//
// Design: K4's block, scratch and phases, with two more before the
// combination: one thread per (item, item vector, user vector) forms the
// cross-Gram over d for the tile's 8 users (float4 loads, left to right,
// four in flight),
// and one thread per pair forms the statistics and the combination weights
// in its own row of X. The item scalar table (2.6 KB per item) is read from
// global memory by the 8 threads of an item together. The combination pass
// is one warp per item, lanes across d, as K4's token pass, with no warp
// sums. X takes 103 KB at the flagship: the scratch ends 6.5 KB short of
// the end of the ring.

#include "attention_common.cuh"

namespace {

using namespace pairwise;
using namespace attn;

// Cross-Grams into X: row r holds, for item vector j and user vector u
// (0: raw, 1 + h: vo_h), vo_j x (raw, vo_0..vo_{H-1}) at j*(1+H) + u, then
// sexp_j x vo_h at n_a + j*H + h and raw_t x vo_h at n_a + (n_vo + t)*H + h,
// n_a = n_vo*(1+H).
template <int TB>
__device__ __forceinline__ void cross_grams(const float* U, float* X,
                                            const Dims& D,
                                            const float* __restrict__ it_raw,
                                            const float* __restrict__ it_vo,
                                            const float* __restrict__ it_sexp,
                                            int c0, int C) {
  const int d = D.d, H = D.H, Mi = D.Mi, n_vo = Mi * H;
  const int n_a = n_vo * (1 + H), per_item = n_a + (n_vo + Mi) * H;
  for (int e = threadIdx.x; e < TC * per_item; e += THREADS) {
    const int ci = e / per_item, idx = e - ci * per_item, c = c0 + ci;
    int u;
    const float* vec;
    if (idx < n_a) {
      const int j = idx / (1 + H);
      u = idx - j * (1 + H);
      vec = it_vo + ((size_t)c * n_vo + j) * d;
    } else {
      const int j = (idx - n_a) / H;
      u = 1 + (idx - n_a - j * H);
      vec = j < n_vo ? it_sexp + ((size_t)c * n_vo + j) * d
                     : it_raw + ((size_t)c * Mi + j - n_vo) * d;
    }
    const float* uv = U + (u ? u_vo_off(D, u - 1) : 0);
    float acc[TB];
#pragma unroll
    for (int bu = 0; bu < TB; ++bu) acc[bu] = 0.f;
    if (c < C) {
#pragma unroll 4
      for (int k = 0; k < d; k += 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(vec + k));
#pragma unroll
        for (int bu = 0; bu < TB; ++bu) {
          const float4 a =
              *reinterpret_cast<const float4*>(uv + bu * D.urow + k);
          acc[bu] = __fadd_rn(acc[bu], __fmul_rn(a.x, x.x));
          acc[bu] = __fadd_rn(acc[bu], __fmul_rn(a.y, x.y));
          acc[bu] = __fadd_rn(acc[bu], __fmul_rn(a.z, x.z));
          acc[bu] = __fadd_rn(acc[bu], __fmul_rn(a.w, x.w));
        }
      }
    }
#pragma unroll
    for (int bu = 0; bu < TB; ++bu) X[(bu * TC + ci) * D.nx + idx] = acc[bu];
  }
}

__device__ __forceinline__ float inv_sigma(float s, float mu, float inv_d) {
  const float var = fmaxf(__fsub_rn(__fmul_rn(s, inv_d), __fmul_rn(mu, mu)),
                          0.f);
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, LN_EPS)));
}

// One thread per pair: the LayerNorm statistics of every token from the
// Grams, then the combination weights into the start of the pair's X row
// (read after the statistics): sig_0, wu_h (H), wv_mh (Mi*H, m*H + h),
// sig_t (Mi), ones.
template <int TB>
__device__ __forceinline__ void gram_stats(const float* U, const float* coef,
                                           float* X, const Dims& D,
                                           const float* __restrict__ it_sc,
                                           int c0, int C) {
  if (threadIdx.x >= Tile<TB>::ROWS) return;
  const int H = D.H, Mi = D.Mi, n_vo = Mi * H, n_a = n_vo * (1 + H);
  const int ci = threadIdx.x / TB, bu = threadIdx.x - ci * TB;
  const int r = bu * TC + ci, c = c0 + ci;
  const float inv_d = __fdiv_rn(1.f, (float)D.d);
  // user scalars: m_uraw, m_uvo (H), g_rr, g_rvo (H), g_vv (H*H)
  const float* us = U + bu * D.urow + u_suu_off(D) + SUU_PAD;
  const float* g_vv = us + 2 + 2 * H;
  // item scalars, ops/attention_scorer.py:gram_layout (rows past C: item 0,
  // never written out)
  const float* is = it_sc + (size_t)(c < C ? c : 0) * D.n_sc;
  const float* m_vo = is;
  const float* m_sexp = m_vo + n_vo;
  const float* m_raw = m_sexp + n_vo;
  const float* g_vovo = m_raw + Mi;
  const float* g_rr = g_vovo + n_vo * n_vo;
  const float* g_rsexp = g_rr + Mi;
  const float* g_ss = g_rsexp + n_vo;
  const float* e_ii = g_ss + Mi * H * H;
  const float* cf = coef + r * D.ncoef;
  float* x = X + r * D.nx;
  auto alpha = [&](int h) { return cf[c0_off(D, h, 0)]; };
  auto beta = [&](int j) { return cf[c0_off(D, j % H, 1 + j / H)]; };
  auto ca = [&](int t, int h) { return cf[ct_off(D, t, h)]; };
  auto cb = [&](int t, int h) { return cf[ct_off(D, t, h) + 1]; };

  // ---- token 0
  float mu0 = us[0];
  for (int h = 0; h < H; ++h) mu0 = __fadd_rn(mu0, __fmul_rn(alpha(h), us[1 + h]));
  for (int j = 0; j < n_vo; ++j) mu0 = __fadd_rn(mu0, __fmul_rn(beta(j), __ldg(m_vo + j)));
  float s0 = us[1 + H];
  for (int h = 0; h < H; ++h)
    s0 = __fadd_rn(s0, __fmul_rn(__fmul_rn(2.f, alpha(h)), us[2 + H + h]));
  for (int h = 0; h < H; ++h)
    for (int h2 = 0; h2 < H; ++h2)
      s0 = __fadd_rn(s0, __fmul_rn(__fmul_rn(alpha(h), alpha(h2)), g_vv[h * H + h2]));
  float q = 0.f;
  for (int j = 0; j < n_vo; ++j) q = __fadd_rn(q, __fmul_rn(beta(j), x[j * (1 + H)]));
  s0 = __fadd_rn(s0, __fmul_rn(2.f, q));
  for (int h = 0; h < H; ++h) {
    q = 0.f;
    for (int j = 0; j < n_vo; ++j)
      q = __fadd_rn(q, __fmul_rn(beta(j), x[j * (1 + H) + 1 + h]));
    s0 = __fadd_rn(s0, __fmul_rn(__fmul_rn(2.f, alpha(h)), q));
  }
  q = 0.f;
  for (int j = 0; j < n_vo; ++j) {
    float inner = 0.f;
#pragma unroll 4
    for (int j2 = 0; j2 < n_vo; ++j2)
      inner = __fadd_rn(inner, __fmul_rn(beta(j2), __ldg(g_vovo + j * n_vo + j2)));
    q = __fadd_rn(q, __fmul_rn(beta(j), inner));
  }
  s0 = __fadd_rn(s0, q);
  const float sig0 = inv_sigma(s0, mu0, inv_d);

  // ---- item tokens
  float sig[MAX_ITEM_MODS], mus[MAX_ITEM_MODS];
  for (int t = 0; t < Mi; ++t) {
    float mu = __ldg(m_raw + t);
    for (int h = 0; h < H; ++h) mu = __fadd_rn(mu, __fmul_rn(ca(t, h), us[1 + h]));
    for (int h = 0; h < H; ++h)
      mu = __fadd_rn(mu, __fmul_rn(cb(t, h), __ldg(m_sexp + t * H + h)));
    float s = __ldg(g_rr + t);
    for (int h = 0; h < H; ++h)
      for (int h2 = 0; h2 < H; ++h2)
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(ca(t, h), ca(t, h2)), g_vv[h * H + h2]));
    q = 0.f;
    for (int h = 0; h < H; ++h)
      q = __fadd_rn(q, __fmul_rn(ca(t, h), x[n_a + (n_vo + t) * H + h]));
    s = __fadd_rn(s, __fmul_rn(2.f, q));
    q = 0.f;
    for (int h = 0; h < H; ++h)
      q = __fadd_rn(q, __fmul_rn(cb(t, h), __ldg(g_rsexp + t * H + h)));
    s = __fadd_rn(s, __fmul_rn(2.f, q));
    q = 0.f;
    for (int h = 0; h < H; ++h)
      for (int h2 = 0; h2 < H; ++h2)
        q = __fadd_rn(q, __fmul_rn(__fmul_rn(ca(t, h), cb(t, h2)),
                                   x[n_a + (t * H + h2) * H + h]));
    s = __fadd_rn(s, __fmul_rn(2.f, q));
    q = 0.f;
    for (int h = 0; h < H; ++h)
      for (int h2 = 0; h2 < H; ++h2)
        q = __fadd_rn(q, __fmul_rn(__fmul_rn(cb(t, h), cb(t, h2)),
                                   __ldg(g_ss + (t * H + h) * H + h2)));
    s = __fadd_rn(s, q);
    sig[t] = inv_sigma(s, mu, inv_d);
    mus[t] = mu;
  }

  // ---- combination weights (X's cross-Grams are no longer read)
  x[0] = sig0;
  for (int h = 0; h < H; ++h) {
    float wv = __fmul_rn(alpha(h), sig0);
    for (int t = 0; t < Mi; ++t) wv = __fadd_rn(wv, __fmul_rn(ca(t, h), sig[t]));
    x[1 + h] = wv;
  }
  for (int m = 0; m < Mi; ++m)
    for (int h = 0; h < H; ++h) {
      float wv = __fmul_rn(beta(m * H + h), sig0);
      for (int t = 0; t < Mi; ++t)
        wv = __fadd_rn(wv, __fmul_rn(__fmul_rn(cb(t, h), sig[t]),
                                     __ldg(e_ii + (t * Mi + m) * H + h)));
      x[1 + H + m * H + h] = wv;
    }
  float ones = __fmul_rn(mu0, sig0);
  for (int t = 0; t < Mi; ++t) {
    x[1 + H + n_vo + t] = sig[t];
    ones = __fadd_rn(ones, __fmul_rn(mus[t], sig[t]));
  }
  x[1 + H + n_vo + Mi] = ones;
}

// The combination pass of warp ci's TB pairs into buf_a, as bf16, UB users
// at a time.
template <int J, int TB>
__device__ __forceinline__ void gram_combine(
    const float* U, const float* X, const Dims& D,
    const float* __restrict__ it_raw, const float* __restrict__ it_vo,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    __nv_bfloat16* buf_a, int stride_a, int c0, int C) {
  constexpr int UB = assembly_users<J, TB>();
  const int lane = threadIdx.x & 31, ci = threadIdx.x >> 5, c = c0 + ci;
  const int d = D.d, H = D.H, Mi = D.Mi, n_vo = Mi * H, half = d / 2;
  if (c >= C) {
    zero_rows<TB>(buf_a, stride_a, ci, d);
    return;
  }
  const float2 zero = make_float2(0.f, 0.f);
  auto urow = [&](int bu, int off, int j) {
    const int s = lane + 32 * j;
    return s < half
        ? reinterpret_cast<const float2*>(U + bu * D.urow + off)[s] : zero;
  };
  auto wt = [&](int bu, int k) { return X[(bu * TC + ci) * D.nx + k]; };
  for (int b0 = 0; b0 < TB; b0 += UB) {
    float2 acc[UB][J], v[J];
#pragma unroll
    for (int bu = 0; bu < UB; ++bu) {
      const float s0 = wt(b0 + bu, 0);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float2 r = urow(b0 + bu, 0, j);
        acc[bu][j] = make_float2(__fmul_rn(s0, r.x), __fmul_rn(s0, r.y));
      }
    }
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int bu = 0; bu < UB; ++bu) {
        const float w = wt(b0 + bu, 1 + h);
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[bu][j] =
              f2_add_mul(acc[bu][j], w, urow(b0 + bu, u_vo_off(D, h), j));
      }
    for (int m = 0; m < Mi; ++m)
      for (int h = 0; h < H; ++h) {
        load_f2(v, it_vo + (((size_t)c * Mi + m) * H + h) * d, half);
#pragma unroll
        for (int bu = 0; bu < UB; ++bu) {
          const float w = wt(b0 + bu, 1 + H + m * H + h);
#pragma unroll
          for (int j = 0; j < J; ++j) acc[bu][j] = f2_add_mul(acc[bu][j], w, v[j]);
        }
      }
    for (int t = 0; t < Mi; ++t) {
      load_f2(v, it_raw + ((size_t)c * Mi + t) * d, half);
#pragma unroll
      for (int bu = 0; bu < UB; ++bu) {
        const float w = wt(b0 + bu, 1 + H + n_vo + t);
#pragma unroll
        for (int j = 0; j < J; ++j) acc[bu][j] = f2_add_mul(acc[bu][j], w, v[j]);
      }
    }
    // gamma * (1/T) carries the token mean; the affine and the bf16 rounding
    float2 g[J], be[J];
    load_f2(g, ln_scale, half);
    load_f2(be, ln_bias, half);
    const float inv_t = __fdiv_rn(1.f, (float)(Mi + 1));
#pragma unroll
    for (int j = 0; j < J; ++j)
      g[j] = make_float2(__fmul_rn(g[j].x, inv_t), __fmul_rn(g[j].y, inv_t));
#pragma unroll
    for (int bu = 0; bu < UB; ++bu) {
      const float ones = wt(b0 + bu, 1 + H + n_vo + Mi);
#pragma unroll
      for (int j = 0; j < J; ++j)
        acc[bu][j] = make_float2(__fsub_rn(acc[bu][j].x, ones),
                                 __fsub_rn(acc[bu][j].y, ones));
      store_fused(acc[bu], g, be, buf_a + ((b0 + bu) * TC + ci) * stride_a,
                  half);
    }
  }
}

template <int J, int TB>
__global__ void __launch_bounds__(THREADS)
attention_gram_kernel(const float* __restrict__ u_raw,
                      const float* __restrict__ u_q,
                      const float* __restrict__ u_k,
                      const float* __restrict__ u_vo,
                      const float* __restrict__ u_suu,
                      const float* __restrict__ u_sc,
                      const float* __restrict__ it_raw,
                      const float* __restrict__ it_q,
                      const float* __restrict__ it_k,
                      const float* __restrict__ it_vo,
                      const float* __restrict__ it_sexp,
                      const float* __restrict__ it_dm,
                      const float* __restrict__ it_sc,
                      const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ w_last,
                      const float* __restrict__ b_last,
                      float* __restrict__ out, int B, int C, Dims D, Chain ch,
                      int act, int fin) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  int u0, c0;
  tile_origin<TB>(&u0, &c0);
  float* U = reinterpret_cast<float*>(buffer_b<TB>(buf_a, ch));
  float* coef = U + TB * D.urow;
  float* X = coef + Tile<TB>::ROWS * D.ncoef;

  load_users<TB>(U, D, u_raw, u_q, u_k, u_vo, u_suu, u_sc, u0, B);
  __syncthreads();
  pair_logits<true, TB>(U, coef, D, it_q, it_k, c0, C);
  cross_grams<TB>(U, X, D, it_raw, it_vo, it_sexp, c0, C);
  __syncthreads();
  softmax_coefs<true, TB>(U, coef, D, it_dm, c0, C);
  __syncthreads();
  gram_stats<TB>(U, coef, X, D, it_sc, c0, C);
  __syncthreads();
  gram_combine<J, TB>(U, X, D, it_raw, it_vo, ln_scale, ln_bias, buf_a,
                      ch.stride_a, c0, C);
  __syncthreads();
  run_chain<TB>(buf_a, w, bias, w_last, b_last, out, B, C, u0, c0, ch, act,
                fin);
}

template <int J>
cudaError_t launch(const void* const* p, const void* w, const void* bias,
                   const void* w_last, const void* b_last, void* out, int B,
                   int C, const Dims& D, const Chain& ch, int act, int fin,
                   int rows, cudaStream_t stream) {
  return dispatch_rows(rows, [&](auto tb) {
    constexpr int TB = decltype(tb)::value;
    dim3 grid;
    size_t smem = 0;
    cudaError_t err = prepare_attention(attention_gram_kernel<J, TB>, ch, D,
                                        B, C, rows, &grid, &smem);
    if (err != cudaSuccess) return err;
    const float* const* f = reinterpret_cast<const float* const*>(p);
    attention_gram_kernel<J, TB><<<grid, THREADS, smem, stream>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
        f[11], f[12], f[13], f[14], static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(w_last),
        static_cast<const float*>(b_last), static_cast<float*>(out), B, C, D,
        ch, act, fin);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) as attention_mlp_forward, with the
// per-user scalar table u_sc [B, 2 + 2H + H*H] after u_suu and the per-item
// scalar table it_sc [C, gram_layout width] after it_dm, and rows the
// block's pair rows. Returns cudaSuccess or the first CUDA error; shapes the
// kernel does not take, or a block that does not fit in shared memory,
// return cudaErrorInvalidValue.
int attention_gram_mlp_forward(
    const void* u_raw, const void* u_q, const void* u_k, const void* u_vo,
    const void* u_suu, const void* u_sc, const void* it_raw,
    const void* it_q, const void* it_k, const void* it_vo,
    const void* it_sexp, const void* it_dm, const void* it_sc,
    const void* ln_scale, const void* ln_bias, const void* w,
    const void* bias, const void* w_last, const void* b_last, void* out,
    int B, int C, int n_hidden, const void* widths, int act, int fin, int H,
    int Mi, int rows, void* stream) {
  Chain ch;
  cudaError_t err = make_chain(n_hidden, static_cast<const int*>(widths), &ch);
  if (err != cudaSuccess) return err;
  Dims D;
  err = make_dims(ch.width[0], H, Mi, true, &D);
  if (err != cudaSuccess) return err;
  const void* p[15] = {u_raw,  u_q,  u_k,   u_vo,    u_suu,
                       u_sc,   it_raw, it_q, it_k,   it_vo,
                       it_sexp, it_dm, it_sc, ln_scale, ln_bias};
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
int attention_gram_mlp_block_bytes(int n_hidden, const void* widths, int H,
                                   int Mi, int rows) {
  Chain ch;
  cudaError_t err = make_chain(n_hidden, static_cast<const int*>(widths), &ch);
  if (err == cudaSuccess) {
    Dims D;
    err = make_dims(ch.width[0], H, Mi, true, &D);
    if (err == cudaSuccess) return (int)attention_smem_bytes(ch, D, rows);
  }
  return -(int)err;
}

}  // extern "C"

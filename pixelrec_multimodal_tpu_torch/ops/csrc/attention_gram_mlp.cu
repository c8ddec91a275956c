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
// Design: K4's block, scratch and phases (the wgmma chain at 128 and 64
// rows, mma.sync below), with the gram form's phases before the
// combination, each spread over the block's 512 threads:
//   cross-Grams: a thread takes one item, one user vector u and D.xg (up
//     to 4) consecutive item vectors of u's list, for all the tile's users,
//     so each user value it loads feeds xg products and each item value TB
//     (float4 loads, the next ones in flight while the last are used, every
//     dot left to right over d);
//   statistics, in three steps behind barriers: one thread per (pair, sum)
//     forms token 0's inner sums over the item Gram and its cross-Gram sums
//     (gram_sums), one thread per (pair, token) the token's mean and
//     1/sigma (gram_tokens), one thread per (pair, weight) the combination
//     weights into the pair's row of X (gram_weights). Every scalar keeps
//     the operation order of the one-thread-per-pair form and of the plain
//     version; the partial sums live in S, at the start of buffer A.
// The item scalar table (2.6 KB per item) is read from global memory by the
// threads of an item together. The combination pass is one warp per item,
// lanes across d, as K4's token pass, with no warp sums. X takes 103 KB at
// the flagship, and S, which the 64 columns of buffer A do not hold, 19 KB:
// the scratch passes buffer B by 40 KB, within the ring.

#include "attention_common.cuh"

namespace {

using namespace pairwise;
using namespace attn;

// Cross-Grams into X: row r holds, for item vector j and user vector u
// (0: raw, 1 + h: vo_h), vo_j x (raw, vo_0..vo_{H-1}) at j*(1+H) + u, then
// sexp_j x vo_h at n_a + j*H + h and raw_t x vo_h at n_a + (n_vo + t)*H + h,
// n_a = n_vo*(1+H). User vector raw pairs with the n_vo vectors vo_j; vo_h
// with the 2 n_vo + Mi vectors vo_j, sexp_j, raw_t (item vector v = n_vo +
// j' lands at n_a + j'*H + h for both of the latter). A thread takes one
// item, one user vector u and D.xg (up to MAX_XG) consecutive item vectors
// of u's list, for all the tile's users: each user value it loads feeds xg
// products and each item value TB, and the next four item values load
// while the last four are used. Every dot runs over d left to right, as
// _seq_dot.
template <int TB>
__device__ __forceinline__ void cross_grams(const float* U, float* X,
                                            const Dims& D,
                                            const float* __restrict__ it_raw,
                                            const float* __restrict__ it_vo,
                                            const float* __restrict__ it_sexp,
                                            int c0, int C) {
  const int d = D.d, H = D.H, Mi = D.Mi, n_vo = Mi * H, xg = D.xg;
  const int n_a = n_vo * (1 + H), n_h = 2 * n_vo + Mi;
  const int g_raw = (n_vo + xg - 1) / xg, g_vo = (n_h + xg - 1) / xg;
  const int per_item = g_raw + H * g_vo;
  for (int e = threadIdx.x; e < TC * per_item; e += THREADS) {
    const int ci = e / per_item, c = c0 + ci;
    int rest = e - ci * per_item, u, v0, nv;
    if (rest < g_raw) {
      u = 0;
      v0 = rest * xg;
      nv = min(xg, n_vo - v0);
    } else {
      rest -= g_raw;
      u = 1 + rest / g_vo;
      v0 = (rest % g_vo) * xg;
      nv = min(xg, n_h - v0);
    }
    const float* vec[MAX_XG];
#pragma unroll
    for (int g = 0; g < MAX_XG; ++g) {
      const int v = v0 + min(g, nv - 1);
      vec[g] = v < n_vo ? it_vo + ((size_t)c * n_vo + v) * d
             : v < 2 * n_vo ? it_sexp + ((size_t)c * n_vo + v - n_vo) * d
                            : it_raw + ((size_t)c * Mi + v - 2 * n_vo) * d;
    }
    const float* uv = U + (u ? u_vo_off(D, u - 1) : 0);
    float acc[MAX_XG][TB];
#pragma unroll
    for (int g = 0; g < MAX_XG; ++g)
#pragma unroll
      for (int bu = 0; bu < TB; ++bu) acc[g][bu] = 0.f;
    if (c < C) {
      float4 x[MAX_XG];
#pragma unroll
      for (int g = 0; g < MAX_XG; ++g)
        x[g] = __ldg(reinterpret_cast<const float4*>(vec[g]));
      for (int k = 0; k < d; k += 4) {
        float4 next[MAX_XG];
        const int kn = k + 4 < d ? k + 4 : k;
#pragma unroll
        for (int g = 0; g < MAX_XG; ++g)
          next[g] = __ldg(reinterpret_cast<const float4*>(vec[g] + kn));
#pragma unroll
        for (int bu = 0; bu < TB; ++bu) {
          const float4 a =
              *reinterpret_cast<const float4*>(uv + bu * D.urow + k);
#pragma unroll
          for (int g = 0; g < MAX_XG; ++g) {
            float s = acc[g][bu];
            s = __fadd_rn(s, __fmul_rn(a.x, x[g].x));
            s = __fadd_rn(s, __fmul_rn(a.y, x[g].y));
            s = __fadd_rn(s, __fmul_rn(a.z, x[g].z));
            acc[g][bu] = __fadd_rn(s, __fmul_rn(a.w, x[g].w));
          }
        }
#pragma unroll
        for (int g = 0; g < MAX_XG; ++g) x[g] = next[g];
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_XG; ++g) {
      if (g >= nv) break;
      const int v = v0 + g;
      const int idx = v < n_vo ? v * (1 + H) + u : n_a + (v - n_vo) * H + u - 1;
#pragma unroll
      for (int bu = 0; bu < TB; ++bu)
        X[(bu * TC + ci) * D.nx + idx] = acc[g][bu];
    }
  }
}

__device__ __forceinline__ float inv_sigma(float s, float mu, float inv_d) {
  const float var = fmaxf(__fsub_rn(__fmul_rn(s, inv_d), __fmul_rn(mu, mu)),
                          0.f);
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, LN_EPS)));
}

// One pair row r's view for the statistics: its user scalars (m_uraw,
// m_uvo (H), g_rr, g_rvo (H), g_vv (H*H)), its item's scalar table
// (ops/attention_scorer.py:gram_layout; rows past C read item 0 and are
// never written out), its coefficients, its rows of X and S. S holds token
// 0's inner sums (n_vo), its cross-Gram sums q_u (1 + H), then mu and
// 1/sigma per token (T = 1 + Mi each).
struct GramPair {
  const float *us, *is, *cf;
  float *x, *s;
  int H, Mi, n_vo;
  const Dims& D;

  __device__ __forceinline__ static GramPair at(const float* U,
                                                const float* coef, float* X,
                                                float* S, const Dims& D,
                                                const float* it_sc, int r,
                                                int c0, int C) {
    const int c = c0 + r % TC;
    return GramPair{U + (r / TC) * D.urow + u_suu_off(D) + SUU_PAD,
                    it_sc + (size_t)(c < C ? c : 0) * D.n_sc,
                    coef + r * D.ncoef, X + r * D.nx, S + r * D.ng,
                    D.H, D.Mi, D.Mi * D.H, D};
  }
  __device__ __forceinline__ float alpha(int h) const {
    return cf[c0_off(D, h, 0)];
  }
  // token 0's weight of item vector j = m*H + h
  __device__ __forceinline__ float beta(int m, int h) const {
    return cf[c0_off(D, h, 1 + m)];
  }
  __device__ __forceinline__ float ca(int t, int h) const {
    return cf[ct_off(D, t, h)];
  }
  __device__ __forceinline__ float cb(int t, int h) const {
    return cf[ct_off(D, t, h) + 1];
  }
  __device__ __forceinline__ const float* g_vv() const { return us + 2 + 2 * H; }
  __device__ __forceinline__ const float* m_vo() const { return is; }
  __device__ __forceinline__ const float* m_sexp() const { return is + n_vo; }
  __device__ __forceinline__ const float* m_raw() const {
    return is + 2 * n_vo;
  }
  __device__ __forceinline__ const float* g_vovo() const {
    return m_raw() + Mi;
  }
  __device__ __forceinline__ const float* g_rr() const {
    return g_vovo() + n_vo * n_vo;
  }
  __device__ __forceinline__ const float* g_rsexp() const {
    return g_rr() + Mi;
  }
  __device__ __forceinline__ const float* g_ss() const {
    return g_rsexp() + n_vo;
  }
  __device__ __forceinline__ const float* e_ii() const {
    return g_ss() + Mi * H * H;
  }
  __device__ __forceinline__ float* mu() const { return s + n_vo + 1 + H; }
  __device__ __forceinline__ float* sig() const { return mu() + Mi + 1; }
};

// Statistics, step 1, one thread per (pair, sum): token 0's inner sums over
// the item Gram, S[j] = sum_j2 beta_j2 g_vovo[j, j2], and its cross-Gram
// sums S[n_vo + u] = sum_j beta_j X[j*(1+H) + u], each left to right.
template <int TB>
__device__ __forceinline__ void gram_sums(const float* U, const float* coef,
                                          float* X, float* S, const Dims& D,
                                          const float* __restrict__ it_sc,
                                          int c0, int C) {
  const int H = D.H, n_vo = D.Mi * H, per = n_vo + 1 + H;
  for (int e = threadIdx.x; e < Tile<TB>::ROWS * per; e += THREADS) {
    const int r = e / per, k = e - r * per;
    const GramPair P = GramPair::at(U, coef, X, S, D, it_sc, r, c0, C);
    const int Mi = D.Mi;
    float q = 0.f;
    if (k < n_vo) {
      const float* g = P.g_vovo() + k * n_vo;
      for (int m = 0; m < Mi; ++m)
#pragma unroll 4
        for (int h = 0; h < H; ++h)
          q = __fadd_rn(q, __fmul_rn(P.beta(m, h), __ldg(g + m * H + h)));
    } else {
      const float* x = P.x + k - n_vo;
      for (int m = 0; m < Mi; ++m)
#pragma unroll 4
        for (int h = 0; h < H; ++h)
          q = __fadd_rn(q, __fmul_rn(P.beta(m, h), x[(m * H + h) * (1 + H)]));
    }
    P.s[k] = q;
  }
}

// Step 2, one thread per (pair, token): the token's mean and 1/sigma from
// the Grams (E[y^2] - mu^2, clamped at 0) into S.
template <int TB>
__device__ __forceinline__ void gram_tokens(const float* U, const float* coef,
                                            float* X, float* S, const Dims& D,
                                            const float* __restrict__ it_sc,
                                            int c0, int C) {
  const int H = D.H, Mi = D.Mi, n_vo = Mi * H, n_a = n_vo * (1 + H);
  const float inv_d = __fdiv_rn(1.f, (float)D.d);
  for (int e = threadIdx.x; e < Tile<TB>::ROWS * (Mi + 1); e += THREADS) {
    const int r = e / (Mi + 1), t = e - r * (Mi + 1);
    const GramPair P = GramPair::at(U, coef, X, S, D, it_sc, r, c0, C);
    const float* us = P.us;
    const float* g_vv = P.g_vv();
    float mu, s, q;
    if (t == 0) {
      mu = us[0];
      for (int h = 0; h < H; ++h)
        mu = __fadd_rn(mu, __fmul_rn(P.alpha(h), us[1 + h]));
      for (int m = 0; m < Mi; ++m)
        for (int h = 0; h < H; ++h)
          mu = __fadd_rn(mu, __fmul_rn(P.beta(m, h),
                                       __ldg(P.m_vo() + m * H + h)));
      s = us[1 + H];
      for (int h = 0; h < H; ++h)
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(2.f, P.alpha(h)), us[2 + H + h]));
      for (int h = 0; h < H; ++h)
        for (int h2 = 0; h2 < H; ++h2)
          s = __fadd_rn(s, __fmul_rn(__fmul_rn(P.alpha(h), P.alpha(h2)),
                                     g_vv[h * H + h2]));
      s = __fadd_rn(s, __fmul_rn(2.f, P.s[n_vo]));
      for (int h = 0; h < H; ++h)
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(2.f, P.alpha(h)),
                                   P.s[n_vo + 1 + h]));
      q = 0.f;
      for (int m = 0; m < Mi; ++m)
        for (int h = 0; h < H; ++h)
          q = __fadd_rn(q, __fmul_rn(P.beta(m, h), P.s[m * H + h]));
      s = __fadd_rn(s, q);
    } else {
      const int ti = t - 1;
      auto ca = [&](int h) { return P.ca(ti, h); };
      auto cb = [&](int h) { return P.cb(ti, h); };
      mu = __ldg(P.m_raw() + ti);
      for (int h = 0; h < H; ++h) mu = __fadd_rn(mu, __fmul_rn(ca(h), us[1 + h]));
      for (int h = 0; h < H; ++h)
        mu = __fadd_rn(mu, __fmul_rn(cb(h), __ldg(P.m_sexp() + ti * H + h)));
      s = __ldg(P.g_rr() + ti);
      for (int h = 0; h < H; ++h)
        for (int h2 = 0; h2 < H; ++h2)
          s = __fadd_rn(s, __fmul_rn(__fmul_rn(ca(h), ca(h2)), g_vv[h * H + h2]));
      q = 0.f;
      for (int h = 0; h < H; ++h)
        q = __fadd_rn(q, __fmul_rn(ca(h), P.x[n_a + (n_vo + ti) * H + h]));
      s = __fadd_rn(s, __fmul_rn(2.f, q));
      q = 0.f;
      for (int h = 0; h < H; ++h)
        q = __fadd_rn(q, __fmul_rn(cb(h), __ldg(P.g_rsexp() + ti * H + h)));
      s = __fadd_rn(s, __fmul_rn(2.f, q));
      q = 0.f;
      for (int h = 0; h < H; ++h)
        for (int h2 = 0; h2 < H; ++h2)
          q = __fadd_rn(q, __fmul_rn(__fmul_rn(ca(h), cb(h2)),
                                     P.x[n_a + (ti * H + h2) * H + h]));
      s = __fadd_rn(s, __fmul_rn(2.f, q));
      q = 0.f;
      for (int h = 0; h < H; ++h)
        for (int h2 = 0; h2 < H; ++h2)
          q = __fadd_rn(q, __fmul_rn(__fmul_rn(cb(h), cb(h2)),
                                     __ldg(P.g_ss() + (ti * H + h) * H + h2)));
      s = __fadd_rn(s, q);
    }
    P.mu()[t] = mu;
    P.sig()[t] = inv_sigma(s, mu, inv_d);
  }
}

// Step 3, one thread per (pair, weight): the combination weights into the
// start of the pair's row of X (its cross-Grams are no longer read):
// sig_0, wu_h (H), wv_mh (Mi*H, m*H + h), sig_t (Mi), ones.
template <int TB>
__device__ __forceinline__ void gram_weights(const float* U, const float* coef,
                                             float* X, float* S,
                                             const Dims& D,
                                             const float* __restrict__ it_sc,
                                             int c0, int C) {
  const int H = D.H, Mi = D.Mi, n_vo = Mi * H, n_w = 2 + H + n_vo + Mi;
  for (int e = threadIdx.x; e < Tile<TB>::ROWS * n_w; e += THREADS) {
    const int r = e / n_w, k = e - r * n_w;
    const GramPair P = GramPair::at(U, coef, X, S, D, it_sc, r, c0, C);
    const float* mu = P.mu();
    const float* sig = P.sig();
    float v;
    if (k == 0) {
      v = sig[0];
    } else if (k <= H) {
      const int h = k - 1;
      v = __fmul_rn(P.alpha(h), sig[0]);
      for (int t = 0; t < Mi; ++t)
        v = __fadd_rn(v, __fmul_rn(P.ca(t, h), sig[1 + t]));
    } else if (k <= H + n_vo) {
      const int j = k - 1 - H, m = j / H, h = j - m * H;
      v = __fmul_rn(P.beta(m, h), sig[0]);
      for (int t = 0; t < Mi; ++t)
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(P.cb(t, h), sig[1 + t]),
                                   __ldg(P.e_ii() + (t * Mi + m) * H + h)));
    } else if (k <= H + n_vo + Mi) {
      v = sig[k - H - n_vo];
    } else {
      v = __fmul_rn(mu[0], sig[0]);
      for (int t = 1; t <= Mi; ++t) v = __fadd_rn(v, __fmul_rn(mu[t], sig[t]));
    }
    P.x[k] = v;
  }
}

// The combination pass of warp ci's TB pairs into buf_a (out), as bf16, UB
// users at a time.
template <int J, int TB, bool SW>
__device__ __forceinline__ void gram_combine(
    const float* U, const float* X, const Dims& D,
    const float* __restrict__ it_raw, const float* __restrict__ it_vo,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const FusedRows<TB, SW>& out, int c0, int C) {
  constexpr int UB = assembly_users<J, TB>();
  const int lane = threadIdx.x & 31, ci = threadIdx.x >> 5, c = c0 + ci;
  const int d = D.d, H = D.H, Mi = D.Mi, n_vo = Mi * H, half = d / 2;
  if (c >= C) {
    zero_rows_at(out, ci, d);
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
      const int r = (b0 + bu) * TC + ci;
      store_fused_at(acc[bu], g, be, [&](int k) { return out.at(r, k); },
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
                      const __nv_bfloat16* __restrict__ w_sw,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ w_last,
                      const float* __restrict__ b_last,
                      float* __restrict__ out, int B, int C, Dims D, WgChain ch,
                      int act, int fin) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr bool SW = wgmma_rows<TB>();
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  int u0, c0;
  tile_origin<TB>(&u0, &c0);
  float* U = reinterpret_cast<float*>(buffer_b<TB>(buf_a, ch));
  float* coef = U + TB * D.urow;
  float* X = coef + Tile<TB>::ROWS * D.ncoef;
  float* S = stats_in_a(D, ch) ? reinterpret_cast<float*>(buf_a)
                               : X + Tile<TB>::ROWS * D.nx;

  load_users<TB>(U, D, u_raw, u_q, u_k, u_vo, u_suu, u_sc, u0, B);
  __syncthreads();
  pair_logits<true, TB>(U, coef, D, it_q, it_k, c0, C);
  cross_grams<TB>(U, X, D, it_raw, it_vo, it_sexp, c0, C);
  __syncthreads();
  softmax_coefs<true, TB>(U, coef, D, it_dm, c0, C);
  __syncthreads();
  gram_sums<TB>(U, coef, X, S, D, it_sc, c0, C);
  __syncthreads();
  gram_tokens<TB>(U, coef, X, S, D, it_sc, c0, C);
  __syncthreads();
  gram_weights<TB>(U, coef, X, S, D, it_sc, c0, C);
  __syncthreads();
  gram_combine<J, TB>(U, X, D, it_raw, it_vo, ln_scale, ln_bias,
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
    cudaError_t err = prepare_attention(attention_gram_kernel<J, TB>, ch, D,
                                        B, C, rows, &grid, &smem);
    if (err != cudaSuccess) return err;
    const float* const* f = reinterpret_cast<const float* const*>(p);
    attention_gram_kernel<J, TB><<<grid, THREADS, smem, stream>>>(
        f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10],
        f[11], f[12], f[13], f[14], static_cast<const __nv_bfloat16*>(p[15]),
        static_cast<const __nv_bfloat16*>(w),
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
// scalar table it_sc [C, gram_layout width] after it_dm, the packed
// weights w_sw after ln_bias, and rows the block's pair rows. Returns cudaSuccess or the first CUDA error; shapes the
// kernel does not take, or a block that does not fit in shared memory,
// return cudaErrorInvalidValue.
int attention_gram_mlp_forward(
    const void* u_raw, const void* u_q, const void* u_k, const void* u_vo,
    const void* u_suu, const void* u_sc, const void* it_raw,
    const void* it_q, const void* it_k, const void* it_vo,
    const void* it_sexp, const void* it_dm, const void* it_sc,
    const void* ln_scale, const void* ln_bias, const void* w_sw,
    const void* w, const void* bias, const void* w_last, const void* b_last,
    void* out, int B, int C, int n_hidden, const void* widths, int act,
    int fin, int H, int Mi, int rows, void* stream) {
  WgChain ch;
  cudaError_t err = make_chain_for(rows, n_hidden,
                                   static_cast<const int*>(widths), &ch);
  if (err != cudaSuccess) return err;
  Dims D;
  err = make_dims(ch.width[0], H, Mi, true, &D);
  if (err != cudaSuccess) return err;
  const void* p[16] = {u_raw,  u_q,  u_k,   u_vo,    u_suu,
                       u_sc,   it_raw, it_q, it_k,   it_vo,
                       it_sexp, it_dm, it_sc, ln_scale, ln_bias, w_sw};
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
  if (!valid_rows(rows)) return -(int)cudaErrorInvalidValue;
  WgChain ch;
  cudaError_t err = make_chain_for(rows, n_hidden,
                                   static_cast<const int*>(widths), &ch);
  if (err == cudaSuccess) {
    Dims D;
    err = make_dims(ch.width[0], H, Mi, true, &D);
    if (err == cudaSuccess) return (int)attention_smem_bytes(ch, D, rows);
  }
  return -(int)err;
}

// The chain a block of `rows` pair rows runs: 2 wgmma, 1 mma.sync.
int attention_gram_mlp_chain_kind(int rows) { return chain_kind(rows); }

}  // extern "C"

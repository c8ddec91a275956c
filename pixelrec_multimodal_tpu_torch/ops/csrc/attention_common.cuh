// pixelrec_multimodal_tpu_torch/ops/csrc/attention_common.cuh
//
// What the attention-fusion kernels share (attention_mlp.cu, K4, the stream
// form; attention_gram_mlp.cu, K5, the gram form; attention_screen_mlp.cu,
// K6, the cascade's token-0 screen): the block's scratch layout, the load of
// the tile's user rows, the per-pair logits and softmax coefficients (K6:
// token 0's half only, the ITEM_TOKENS flag), token 0's attention input, the
// warp sums and LayerNorm, and the launch set-up. Each kernel then forms its
// pairs' fused d-vectors its own way, writes them as bf16 into buf_a
// (FusedRows: in the wgmma chain's swizzled layout at 128 and 64
// rows) and runs the chain with the first Dense w1 as its layer 0:
// run_chain_of (mlp_chain_wgmma.cuh: wgmma at 128 and 64 rows, run_chain of
// mlp_chain.cuh below).
//
// Block: the chain's TB users x 16 items (TB = 8, 4, 2 or 1: 128 to 16 pair
// rows, the largest whose block fits by <name>_block_bytes;
// ops/pairwise_mlp.py:block_rows), 16 warps. Shared memory is the chain's (two
// activation buffers and the weight ring). Until the assembly ends, buffer B
// and the ring behind it are the assembly's scratch (buffer B is first
// written by the chain's layer 0), and for K5 buffer A too until its
// combination pass writes the fused vectors:
//   U    [TB][urow]   the tile's user rows: raw, q, k, vo_0 .. vo_{H-1} (d
//                     each, vs = d + 4 apart, so that float4 reads of
//                     different vectors fall in different banks), suu
//                     (SUU_PAD), and for K5 the user scalars (n_usc)
//   coef [ROWS][ncoef] per pair: token 0's softmax weights per head (the
//                     user key first, then the Mi item keys), then (not K6)
//                     per item token t and head h the pair (a, b) of the
//                     stream form
//   X    [ROWS][nx]   K5 only: cross-Grams, later the combination weights
//   S    [ROWS][ng]   K5 only: the statistics' partial sums and each token's
//                     mean and 1/sigma, at the start of buffer A where they
//                     fit there (stats_in_a), else after X
// Every float32 operation of the assembly is an unfused __f*_rn intrinsic in
// the order the module's plain version (ops/attention_scorer.py) takes, so
// kernel and plain version round the fused vector to the same bf16 values.
// A warp holds J float2 slots per lane of each d-wide vector (J = 1, 2, 4 or
// 8 up to d 64, 128, 256, 512); at J = 8 the assembly takes its users in
// groups of two and streams the item rows one at a time (assembly_users,
// row_buffers), so that its registers stay within the 128 a thread of a
// 512-thread block may hold. Neither changes any pair's operations.

#pragma once

#include "mlp_chain.cuh"
#include "mlp_chain_wgmma.cuh"

namespace attn {

using namespace pairwise;

constexpr int MAX_HEADS = 8;
constexpr int MAX_ITEM_MODS = 7;
constexpr int SUU_PAD = 8;       // columns of the per-user self-logit table
constexpr int MAX_D = 512;       // 8 float2 slots per lane
constexpr float LN_EPS = 1e-6f;  // Flax nn.LayerNorm
constexpr float EXP_CLAMP = 80.f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_XG = 4;  // K5's cross-Gram item vectors a thread, at most
static_assert(WARPS == TC, "the assembly runs one warp per item of the tile");

struct Dims {
  int d, H, dh, Mi;
  int n_usc, n_sc;  // user / item scalar columns (K5), 0 for K4
  int vs;           // stride of the vectors in a user row, d + 4
  int urow;         // floats per user row in scratch, a multiple of 4
  int ncoef;        // coefficient row stride, odd (no bank conflicts): the
                    // item tokens' (a, b) too unless the kernel is K6
  int nx;           // K5 row stride of X, odd; 0 for K4
  int ng;           // K5 row stride of S, odd; 0 for K4
  int xg;           // K5 cross-Gram item vectors per thread
};

// Offsets within a user row and a coefficient row.
// raw, q and k are vectors 0, 1 and 2 of the row, vo_h vector 3 + h.
__host__ __device__ __forceinline__ int u_vo_off(const Dims& D, int h) {
  return (3 + h) * D.vs;
}
__host__ __device__ __forceinline__ int u_suu_off(const Dims& D) {
  return (3 + D.H) * D.vs;
}
__host__ __device__ __forceinline__ int c0_off(const Dims& D, int h, int j) {
  return h * (D.Mi + 1) + j;  // j = 0: the user key, 1 + m: item key m
}
__host__ __device__ __forceinline__ int ct_off(const Dims& D, int t, int h) {
  return D.H * (D.Mi + 1) + (t * D.H + h) * 2;  // + 0: a, + 1: b
}

inline cudaError_t make_dims(int d, int H, int Mi, bool gram, Dims* D,
                             bool item_tokens = true) {
  if (d < 16 || d > MAX_D || d % 16 || H < 1 || H > MAX_HEADS || d % H ||
      Mi < 1 || Mi > MAX_ITEM_MODS)
    return cudaErrorInvalidValue;
  *D = Dims{};
  D->d = d;
  D->H = H;
  D->dh = d / H;
  D->Mi = Mi;
  D->vs = d + 4;
  const int n_vo = Mi * H;
  if (gram) {
    D->n_usc = 2 + 2 * H + H * H;
    D->n_sc = 3 * n_vo + Mi + n_vo * n_vo + Mi + Mi * H * H + Mi * Mi * H;
    const int n_x = n_vo * (1 + H) + (n_vo + Mi) * H;  // cross-Grams
    const int n_w = 2 + H + n_vo + Mi;                 // combination weights
    D->nx = (n_x > n_w ? n_x : n_w) | 1;
    // S: token 0's inner sums over the item Gram (n_vo) and its cross-Gram
    // sums (1 + H), then mu and 1/sigma per token
    D->ng = (n_vo + 1 + H + 2 * (Mi + 1)) | 1;
    // cross-Gram item vectors per thread: the most whose cost (rounds of
    // the block's threads times the vectors each holds) is within a
    // quarter of the least, as more vectors let each load feed more
    // products
    int cost[MAX_XG + 1], least = 0;
    for (int g = 1; g <= MAX_XG; ++g) {
      const int units = TC * ((n_vo + g - 1) / g +
                              H * ((2 * n_vo + Mi + g - 1) / g));
      cost[g] = (units + THREADS - 1) / THREADS * g;
      if (!least || cost[g] < least) least = cost[g];
    }
    for (int g = 1; g <= MAX_XG; ++g)
      if (4 * cost[g] <= 5 * least) D->xg = g;
  }
  D->urow = (u_suu_off(*D) + SUU_PAD + D->n_usc + 3) / 4 * 4;
  D->ncoef = (H * (Mi + 1) + (item_tokens ? 2 * Mi * H : 0)) | 1;
  return cudaSuccess;
}

// The assembly's scratch of a block of `rows` pair rows, in bytes.
inline size_t scratch_bytes(const Dims& D, int rows) {
  return ((size_t)(rows / TC) * D.urow + (size_t)rows * (D.ncoef + D.nx)) * 4;
}

// Users the assembly holds in registers at once, and item rows it loads
// ahead, for J float2 slots per lane.
template <int J, int TB>
__host__ __device__ constexpr int assembly_users() {
  return J >= 8 ? (TB < 2 ? TB : 2) : TB;
}
template <int J>
__host__ __device__ constexpr int row_buffers() {
  return J >= 8 ? 1 : (MAX_HEADS > MAX_ITEM_MODS ? MAX_HEADS : MAX_ITEM_MODS);
}

__device__ __forceinline__ float2 f2_add_mul(float2 y, float w, float2 v) {
  return make_float2(__fadd_rn(y.x, __fmul_rn(w, v.x)),
                     __fadd_rn(y.y, __fmul_rn(w, v.y)));
}

__device__ __forceinline__ float warp_sum(float p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(FULL, p, o));
  return p;
}

// The tile's user rows into U; rows past B, and the padding after each
// vector, are zeros.
template <int TB>
__device__ __forceinline__ void load_users(
    float* U, const Dims& D, const float* __restrict__ u_raw,
    const float* __restrict__ u_q, const float* __restrict__ u_k,
    const float* __restrict__ u_vo, const float* __restrict__ u_suu,
    const float* __restrict__ u_sc, int u0, int B) {
  const int d = D.d, so = u_suu_off(D);
  for (int e = threadIdx.x; e < TB * D.urow; e += THREADS) {
    const int bu = e / D.urow, j = e - bu * D.urow;
    const int vec = j / D.vs, k = j - vec * D.vs;
    const size_t u = u0 + bu;
    float v = 0.f;
    if (u0 + bu < B) {
      if (j < so) {
        if (k < d)
          v = vec == 0 ? u_raw[u * d + k]
            : vec == 1 ? u_q[u * d + k]
            : vec == 2 ? u_k[u * d + k]
                       : u_vo[(u * D.H + vec - 3) * d + k];
      } else if (j < so + SUU_PAD) v = u_suu[u * SUU_PAD + j - so];
      else if (j < so + SUU_PAD + D.n_usc)
        v = u_sc[u * D.n_usc + j - so - SUU_PAD];
    }
    U[e] = v;
  }
}

// Per-pair logits into the coefficient rows. One thread per (item, key or
// query, token, head) forms the dot over dh for all 8 users of the tile,
// left to right: token 0's user query against item key m (slot
// c0_off(h, 1 + m)) and, with ITEM_TOKENS, item query t against the user key
// (slot ct_off(t, h)). Items past C give zero logits.
template <bool ITEM_TOKENS, int TB>
__device__ __forceinline__ void pair_logits(const float* U, float* coef,
                                            const Dims& D,
                                            const float* __restrict__ it_q,
                                            const float* __restrict__ it_k,
                                            int c0, int C) {
  const int d = D.d, H = D.H, dh = D.dh, Mi = D.Mi;
  constexpr int KINDS = ITEM_TOKENS ? 2 : 1;
  for (int e = threadIdx.x; e < TC * KINDS * Mi * H; e += THREADS) {
    const int h = e % H, m = (e / H) % Mi;
    const int kind = ITEM_TOKENS ? (e / (H * Mi)) % 2 : 0;
    const int ci = e / (KINDS * H * Mi), c = c0 + ci;
    float acc[TB];
#pragma unroll
    for (int bu = 0; bu < TB; ++bu) acc[bu] = 0.f;
    if (c < C) {
      const float* iv =
          (kind ? it_q : it_k) + ((size_t)c * Mi + m) * d + h * dh;
      const float* uv = U + (kind ? 2 : 1) * D.vs + h * dh;
#pragma unroll 4
      for (int i = 0; i < dh; ++i) {
        const float x = __ldg(iv + i);
#pragma unroll
        for (int bu = 0; bu < TB; ++bu)
          acc[bu] = __fadd_rn(acc[bu], __fmul_rn(uv[bu * D.urow + i], x));
      }
    }
    const int slot = kind ? ct_off(D, m, h) : c0_off(D, h, 1 + m);
#pragma unroll
    for (int bu = 0; bu < TB; ++bu)
      coef[(bu * TC + ci) * D.ncoef + slot] = acc[bu];
  }
}

// The logits into softmax coefficients, in place. Token 0, per (pair,
// head): exp(l - max) over the user's self logit and the Mi item-key
// logits, each times 1 / their sum. With ITEM_TOKENS, item token t, per
// (pair, head): e_u = exp(min(s - mx, 80)) against the item-key softmax
// mass (dsum, mx) of the dm table, a = e_u * r and b = r with
// r = 1 / (e_u + dsum).
template <bool ITEM_TOKENS, int TB>
__device__ __forceinline__ void softmax_coefs(const float* U, float* coef,
                                              const Dims& D,
                                              const float* __restrict__ it_dm,
                                              int c0, int C) {
  constexpr int ROWS = Tile<TB>::ROWS;
  const int H = D.H, Mi = D.Mi, n0 = ROWS * H;
  const int n = n0 + (ITEM_TOKENS ? ROWS * Mi * H : 0);
  for (int e = threadIdx.x; e < n; e += THREADS) {
    if (!ITEM_TOKENS || e < n0) {
      const int r = e / H, h = e - r * H, bu = r / TC;
      float* cf = coef + r * D.ncoef + c0_off(D, h, 0);
      const float lu = U[bu * D.urow + u_suu_off(D) + h];
      float mx = lu;
      for (int m = 0; m < Mi; ++m) mx = fmaxf(mx, cf[1 + m]);
      const float e0 = expf(__fsub_rn(lu, mx));
      float tot = e0;
      for (int m = 0; m < Mi; ++m) {
        const float em = expf(__fsub_rn(cf[1 + m], mx));
        cf[1 + m] = em;
        tot = __fadd_rn(tot, em);
      }
      const float inv = __fdiv_rn(1.f, tot);
      cf[0] = __fmul_rn(e0, inv);
      for (int m = 0; m < Mi; ++m) cf[1 + m] = __fmul_rn(cf[1 + m], inv);
    } else {
      const int k = e - n0, h = k % H, t = (k / H) % Mi, r = k / (H * Mi);
      const int c = c0 + r % TC;
      float* cf = coef + r * D.ncoef + ct_off(D, t, h);
      float dsum = 1.f, mx = 0.f;
      if (c < C) {
        const float* dm = it_dm + (size_t)c * H * Mi * 2 + (h * Mi + t) * 2;
        dsum = dm[0];
        mx = dm[1];
      }
      const float eu = expf(fminf(__fsub_rn(cf[0], mx), EXP_CLAMP));
      const float rr = __fdiv_rn(1.f, __fadd_rn(eu, dsum));
      cf[0] = __fmul_rn(eu, rr);
      cf[1] = rr;
    }
  }
}

// Where the assembly writes entry k of pair row r's fused vector in buf_a:
// row-major rows of `stride` elements for run_chain, the swizzled blocks of
// run_chain_wgmma (SW: 128 and 64 rows).
template <int TB, bool SW>
struct FusedRows {
  __nv_bfloat16* buf;
  int stride;
  __device__ __forceinline__ __nv_bfloat16* at(int r, int k) const {
    if constexpr (SW) return buf + sw_offset<Tile<TB>::ROWS>(r, k);
    else return buf + r * stride + k;
  }
};

// One warp's pairs of its item: zero rows for an item past C (never
// written out), and the LayerNorm affine plus the bf16 rounding of a fused
// vector held as J float2 slots per lane (slot s = lane + 32 j covers
// entries 2s, 2s + 1), entry k written at at(k).
template <int TB, bool SW>
__device__ __forceinline__ void zero_rows_at(const FusedRows<TB, SW>& out,
                                             int ci, int d) {
  const int lane = threadIdx.x & 31;
  for (int bu = 0; bu < TB; ++bu)
    for (int k = lane; k < d; k += 32)
      *out.at(bu * TC + ci, k) = __float2bfloat16_rn(0.f);
}

template <int J, typename At>
__device__ __forceinline__ void store_fused_at(const float2 (&f)[J],
                                               float2 (&g)[J],
                                               float2 (&be)[J], At at,
                                               int half) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = lane + 32 * j;
    if (s < half)
      *reinterpret_cast<__nv_bfloat162*>(at(2 * s)) = __floats2bfloat162_rn(
          __fadd_rn(__fmul_rn(f[j].x, g[j].x), be[j].x),
          __fadd_rn(__fmul_rn(f[j].y, g[j].y), be[j].y));
  }
}

template <int J>
__device__ __forceinline__ void load_f2(float2 (&v)[J],
                                        const float* __restrict__ p,
                                        int half) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = lane + 32 * j;
    v[j] = s < half ? __ldg(reinterpret_cast<const float2*>(p) + s)
                    : make_float2(0.f, 0.f);
  }
}

// u_vo of the tile's user bu, head h, at this lane's slot j.
__device__ __forceinline__ float2 user_vo(const float* U, const Dims& D,
                                          int bu, int h, int j, int half) {
  const int s = (threadIdx.x & 31) + 32 * j;
  return s < half ? reinterpret_cast<const float2*>(U + bu * D.urow +
                                                    u_vo_off(D, h))[s]
                  : make_float2(0.f, 0.f);
}

// Token 0's pre-LayerNorm vectors of warp ci's pairs with item c for the
// UB users b0 .. b0 + UB - 1 of the tile, added into y (zero on entry):
// y = raw + sum_h (w_0h u_vo_h + sum_m w_mh vo_mh), the attention output
// summed first, then the residual. With R >= MAX_ITEM_MODS row buffers a
// head's Mi item rows are loaded together before they are used, so the warp
// waits on global memory once per head, not once per row; with R = 1 each
// row is loaded where it is used. `rows` is the caller's scratch for them.
template <int J, int R, int UB>
__device__ __forceinline__ void token0_input(const float* U, const float* coef,
                                             const Dims& D,
                                             const float* __restrict__ it_vo,
                                             float2 (&rows)[R][J],
                                             float2 (&y)[UB][J], int c,
                                             int ci, int b0) {
  constexpr bool AHEAD = R >= MAX_ITEM_MODS;
  const int lane = threadIdx.x & 31, d = D.d, H = D.H, Mi = D.Mi;
  const int half = d / 2;
  for (int h = 0; h < H; ++h) {
    if constexpr (AHEAD) {
#pragma unroll
      for (int m = 0; m < MAX_ITEM_MODS; ++m)
        if (m < Mi) load_f2(rows[m], it_vo + (((size_t)c * Mi + m) * H + h) * d, half);
    }
#pragma unroll
    for (int bu = 0; bu < UB; ++bu) {
      const float w = coef[((b0 + bu) * TC + ci) * D.ncoef + c0_off(D, h, 0)];
#pragma unroll
      for (int j = 0; j < J; ++j)
        y[bu][j] = f2_add_mul(y[bu][j], w, user_vo(U, D, b0 + bu, h, j, half));
    }
#pragma unroll
    for (int m = 0; m < MAX_ITEM_MODS; ++m) {
      if (m >= Mi) break;
      if constexpr (!AHEAD)
        load_f2(rows[0], it_vo + (((size_t)c * Mi + m) * H + h) * d, half);
      const float2 (&row)[J] = rows[AHEAD ? m : 0];
#pragma unroll
      for (int bu = 0; bu < UB; ++bu) {
        const float w =
            coef[((b0 + bu) * TC + ci) * D.ncoef + c0_off(D, h, 1 + m)];
#pragma unroll
        for (int j = 0; j < J; ++j) y[bu][j] = f2_add_mul(y[bu][j], w, row[j]);
      }
    }
  }
#pragma unroll
  for (int bu = 0; bu < UB; ++bu) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = lane + 32 * j;
      const float2 r = s < half
          ? reinterpret_cast<const float2*>(U + (b0 + bu) * D.urow)[s]
          : make_float2(0.f, 0.f);
      y[bu][j] = make_float2(__fadd_rn(r.x, y[bu][j].x),
                             __fadd_rn(r.y, y[bu][j].y));
    }
  }
}

// Residual + LayerNorm of one token of one pair, scaled by 1/T and added to
// f: mean and centred variance are warp sums, each lane adding its entries
// in order first.
template <int J>
__device__ __forceinline__ void layer_norm_add(const float2 (&y)[J],
                                               float2 (&f)[J], int half,
                                               float inv_d, float inv_t) {
  const int lane = threadIdx.x & 31;
  float p = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lane + 32 * j < half) {
      p = __fadd_rn(p, y[j].x);
      p = __fadd_rn(p, y[j].y);
    }
  const float mu = __fmul_rn(warp_sum(p), inv_d);
  float2 yc[J];
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    yc[j] = make_float2(__fsub_rn(y[j].x, mu), __fsub_rn(y[j].y, mu));
    if (lane + 32 * j < half) {
      q = __fadd_rn(q, __fmul_rn(yc[j].x, yc[j].x));
      q = __fadd_rn(q, __fmul_rn(yc[j].y, yc[j].y));
    }
  }
  const float var = __fmul_rn(warp_sum(q), inv_d);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, LN_EPS)));
#pragma unroll
  for (int j = 0; j < J; ++j) {
    f[j].x = __fadd_rn(f[j].x, __fmul_rn(__fmul_rn(yc[j].x, rs), inv_t));
    f[j].y = __fadd_rn(f[j].y, __fmul_rn(__fmul_rn(yc[j].y, rs), inv_t));
  }
}

// K5's statistics scratch S lies at the start of buffer A where its rows
// fit there (buffer A is free until the combination pass writes it), else
// after X.
__host__ __device__ __forceinline__ bool stats_in_a(const Dims& D,
                                                   const Chain& ch) {
  return 2 * D.ng <= ch.stride_a;
}

// The part of the assembly's scratch (K5's statistics included where they
// do not fit in buffer A) that passes buffer B, in bytes.
inline size_t scratch_past_b(const Chain& ch, const Dims& D, int rows) {
  const size_t buf_b = (size_t)rows * ch.stride_b * 2;
  const size_t need = scratch_bytes(D, rows) +
                      (stats_in_a(D, ch) ? 0 : (size_t)rows * D.ng * 4);
  return need > buf_b ? need - buf_b : 0;
}

// Shared memory of a block of `rows` pair rows: the chain's (the wgmma
// chain's at 128 and 64 rows), with the assembly's scratch counted from
// buffer B on (only what passes buffer B grows the ring).
inline size_t attention_smem_bytes(const WgChain& ch, const Dims& D,
                                   int rows) {
  return smem_bytes_for(ch, scratch_past_b(ch, D, rows), rows);
}

// Launch set-up: the chain's; the grid puts the user tiles on x, so the
// blocks of one item tile run together and the tile stays in L2.
template <typename Kernel, typename ChainT>
inline cudaError_t prepare_attention(Kernel kernel, const ChainT& ch,
                                     const Dims& D, int B, int C, int rows,
                                     dim3* grid, size_t* smem) {
  *smem = attention_smem_bytes(ch, D, rows);
  cudaError_t err = prepare_launch(kernel, *smem, B, C, rows, grid);
  if (err != cudaSuccess) return err;
  if (grid->x > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3(grid->y, grid->x);
  return cudaSuccess;
}

template <int TB>
__device__ __forceinline__ void tile_origin(int* u0, int* c0) {
  *u0 = blockIdx.x * TB;
  *c0 = blockIdx.y * TC;
}

// Slots per lane for an embedding width: 1 up to d = 64, 2 up to 128, 4 up
// to 256, 8 up to MAX_D.
inline int slots_per_lane(int d) {
  return d <= 64 ? 1 : d <= 128 ? 2 : d <= 256 ? 4 : 8;
}

}  // namespace attn

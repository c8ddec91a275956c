// pixelrec_multimodal_tpu_torch/ops/csrc/mlp_chain_wgmma_int8.cuh
//
// The int8 chain of mlp_chain_int8.cuh on Hopper's warpgroup products
// (wgmma.mma_async m64n128k32 s8 x s8 -> s32), for the int8 modes of the
// pair kernels K1q (pairwise_mlp.cu), K2q (gated_pairwise_mlp.cu) and K3q
// (gated_factored_mlp.cu) at blocks of 128 rows, and of 64 where that
// block fits (make_chain_fit_int8). Every block of 32 and 16 rows keeps
// run_chain_int8. It keeps run_chain_int8's
// contract: layer 0's codes in buffer A, w the quantized weights, qp the
// (inv_a, off) slots then each layer's out_scale and bias_eff; each hidden
// layer's epilogue act(f32(acc) * out_scale + bias_eff), every product and
// sum rounded on its own, then the next layer's codes (quantize); the last
// hidden layer's f32 output straight into the last dot.
//
// Why: mma.sync s8 fed by ldmatrix runs the int8 product loop at 329
// TOP/s (P3), no faster than the bf16 wgmma chain (332-400 TFLOP/s on the
// same widths), so the int8 modes paid a quantize per pair and a rescale
// per layer for nothing. wgmma is the card's only way to its int8 tensor
// rate (1,979 TOP/s on the data sheet).
//
// The s8 form lines up byte for byte with the bf16 chain of
// mlp_chain_wgmma.cuh: an instruction reads 32 bytes of k (32 codes where
// the bf16 one reads 16 values), the 128-byte swizzle atom holds 128 codes,
// and a ring stage of one k slice x 128 columns is 16 KB in both. So the
// descriptors (sw128_desc), the ring, its bulk copies and barriers
// (WeightStream<TB, int8_t>), the four k steps per slice, the groups and
// the in-place rule are the bf16 chain's, with "element" read as "byte".
// Both operands are K-major (the integer form has no transpose): buffer A
// holds [ROWS][128] code blocks, a row 128 bytes, its 16-byte chunks
// swizzled by the row (sw_byte_offset); the weights come packed by the host
// (ops/pairwise_mlp.py:wgmma_weights): per layer, wq^T [N, K] zero-padded
// to [N64, K128], cut into [64 n][128 k] byte tiles in the same swizzled
// layout, in the order (k slice, column group). The int32 sums are exact
// in any order (|sum| <= K * 128 * 127), so every code is the mma.sync
// chain's.
//
// The last dot keeps the float32 order of run_chain_int8's 128-row block:
// the m64n128 fragment gives a thread of warp w, lane l the rows 16w + l/4
// (+8) and the columns 8j + 2(l%4) (+1) of its 128-column tile, so it
// keeps one partial sum per half tile (j 0-7, 8-15), added in j order,
// sums the quad by __shfl_xor 1 and 2, and stores one float per (row, tile,
// half): the (row, pass, column group) order of the mma.sync chain at 128
// rows (CG = 2, WN = 64), whatever the row count. K1q, K2q and K3q at 128
// and 64 rows give the mma.sync chain's 128-row scores bit for bit.
//
// Bound at the flagship [512, 256, 128]: 327,680 int8 products a pair
// (0.347 ms for a 256 x 8,192 block at 1,979 TOP/s) beside about the same
// f32 time for the gated assembly, its quantize and every layer's rescale
// and quantize on the CUDA cores; the design takes the products off the
// critical path so that those f32 phases set the pace. Buffer A holds 64
// KB of codes at 128 rows (half of bf16's), every layer writes over it,
// and eight 16 KB stages fit (196,672 B).

#pragma once

#include "mlp_chain_int8.cuh"
#include "mlp_chain_wgmma.cuh"

namespace pairwise {

constexpr int WQ_K = 128;  // codes (k) per ring stage: one 128-byte atom

// Byte offset of (pair row r, column k) in a swizzled code buffer of ROWS
// rows: blocks of [ROWS][128] codes, 16-byte chunks swizzled by r % 8.
template <int ROWS>
__host__ __device__ __forceinline__ int sw_byte_offset(int r, int k) {
  return (k >> 7) * (ROWS * 128) + r * 128 +
         ((((k >> 4) & 7) ^ (r & 7)) << 4) + (k & 15);
}

// The accumulators are not moved across the asynchronous products.
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 s32, the fragment of wgmma_64x128x16) += A (64 x 32 codes,
// desc a) x B (32 x 128 codes, desc b); both K-major.
__device__ __forceinline__ void wgmma_64x128x32_s8(int (&d)[64], uint64_t a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// act(f32(acc) * out_scale + bias_eff) of the thread's column pair (col,
// col + 1) from fragment entries acc[i], acc[i + 1], unfused, for
// activation code ACT (a constant: see store_group).
template <int ACT>
__device__ __forceinline__ float2 rescale_pair(int a0, int a1, float2 s,
                                               float2 e) {
  return make_float2(
      act_fn(__fadd_rn(__fmul_rn(__int2float_rn(a0), s.x), e.x), ACT),
      act_fn(__fadd_rn(__fmul_rn(__int2float_rn(a1), s.y), e.y), ACT));
}

// A warpgroup's share of a hidden layer's epilogue (not the last): the
// rescale, then the next layer's codes (inv_a, off) at (row, col0 + 8j)
// and eight rows down, and zero codes in the pad columns up to a multiple
// of 128, which the next layer's last k slice reads. The scale and bias
// pairs of eight column chunks load together (a column past N reads the
// last pair).
template <int ACT, int ROWS>
__device__ __forceinline__ void store_group_int8(
    const int (&acc)[64], const float* __restrict__ scale,
    const float* __restrict__ beff, float inv_a, float off,
    unsigned char* dst, int row, int col0, int N) {
#pragma unroll
  for (int j0 = 0; j0 < 16; j0 += 8) {
    float2 sv[8], ev[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = min(col0 + (j0 + j) * 8, N - 2);
      sv[j] = __ldg(reinterpret_cast<const float2*>(scale + c));
      ev[j] = __ldg(reinterpret_cast<const float2*>(beff + c));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j0 + j) * 8, i = 4 * (j0 + j);
      const bool pad = col >= N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v =
            rescale_pair<ACT>(acc[i + 2 * h], acc[i + 2 * h + 1], sv[j], ev[j]);
        const uint16_t code =
            pad ? (uint16_t)0
                : (uint16_t)((quantize(v.x, inv_a, off) & 0xff) |
                             ((quantize(v.y, inv_a, off) & 0xff) << 8));
        *reinterpret_cast<uint16_t*>(
            dst + sw_byte_offset<ROWS>(row + 8 * h, col)) = code;
      }
    }
  }
}

// A warpgroup's share of the last hidden layer's epilogue: each rescaled
// value times its w_last entry, summed per (row, half tile) over the
// thread's columns in j order, then over the quad (xor 1, then 2); lane
// 4g writes rows row and row + 8 of sums [ROWS][n_part] at parts p0 (j
// 0-7) and p0 + 1 (j 8-15). Columns past N add nothing.
template <int ACT>
__device__ __forceinline__ void last_group_int8(
    const int (&acc)[64], const float* __restrict__ scale,
    const float* __restrict__ beff, const float* __restrict__ w_last,
    float* sums, int row, int col0, int N, int p0, int n_part) {
  float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [half][row, row + 8]
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = half * 8 + j, col = col0 + jj * 8, i = 4 * jj;
      if (col < N) {
        const float2 s = make_float2(scale[col], scale[col + 1]);
        const float2 e = make_float2(beff[col], beff[col + 1]);
        const float wl0 = w_last[col], wl1 = w_last[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v =
              rescale_pair<ACT>(acc[i + 2 * h], acc[i + 2 * h + 1], s, e);
          part[half][h] = __fadd_rn(part[half][h], __fmul_rn(v.x, wl0));
          part[half][h] = __fadd_rn(part[half][h], __fmul_rn(v.y, wl1));
        }
      }
    }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p = part[half][h];
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
      if ((lane & 3) == 0) sums[(row + 8 * h) * n_part + p0 + half] = p;
    }
}

// run_chain_int8 on the s8 wgmma chain: buffer A (at smem) holds layer 0's
// codes in the swizzled layout, w the packed weights; every thread has
// passed a __syncthreads since writing them. Row r is user u0 + r / TC,
// item c0 + r % TC; only rows inside [B, C] are written to out.
template <int TB>
__device__ __forceinline__ void run_chain_wgmma_int8(
    unsigned char* smem, const int8_t* __restrict__ w,
    const float* __restrict__ qp, const float* __restrict__ w_last,
    const float* __restrict__ b_last, float* __restrict__ out, int B, int C,
    int u0, int c0, const WgChain& ch, int act, int fin) {
  using T = WgTile<TB>;
  constexpr int ROWS = T::ROWS;
  const int S = ch.stages;
  unsigned char* wbuf = ring_int8<TB>(smem, ch);
  uint64_t* full = reinterpret_cast<uint64_t*>(wbuf + S * WG_STAGE_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, mt = wg % T::MT, nt = wg / T::MT;

  WeightStream<TB, int8_t> stream{w};
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s]);
    mbar_init_fence();
  }
  // Zero codes in buffer A's pad columns, from the assembly's d up to a
  // multiple of 128, which the first layer's last k slice reads (against
  // zero weights: any code would do, but nothing reads unwritten memory).
  {
    const int d = ch.width[0], pad = (d + WQ_K - 1) / WQ_K * WQ_K - d;
    for (int e = tid; e < ROWS * pad; e += THREADS)
      smem[sw_byte_offset<ROWS>(e / pad, d + e % pad)] = 0;
  }
  // The assembly's writes (buffer A, and its scratch where the ring now
  // lands) are ordered before the async proxy's reads and copies.
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S && stream.more(ch); ++s)
      stream.issue(ch, wbuf + s * WG_STAGE_BYTES, &full[s]);
  // Thread 0 refills the n stages from tile t on, once every warpgroup is
  // done with them.
  auto refill = [&](unsigned t, int n) {
    if (tid == 0)
      for (int i = 0; i < n && stream.more(ch); ++i)
        stream.issue(ch, wbuf + ((t + i) % S) * WG_STAGE_BYTES,
                     &full[(t + i) % S]);
  };

  unsigned tile = 0;  // stages consumed: stage tile % S, its phase
  unsigned char* in = smem;
  unsigned char* other = smem + ROWS * ch.stride_a;
  for (int l = 0; l < ch.n_hidden; ++l) {
    const int K = ch.width[l], N = ch.width[l + 1];
    const float* scale = qp + ch.b_off[l];
    const float* beff = scale + N;
    const bool last = l == ch.n_hidden - 1;
    // the next layer's quantize (the last hidden layer feeds the last dot)
    const float inv_a = last ? 0.f : qp[2 * (l + 1)];
    const float off = last ? 0.f : qp[2 * (l + 1) + 1];
    const int n_part = 2 * ((N + WG_N - 1) / WG_N);
    unsigned char* dst = (ch.in_place >> l) & 1 ? in : other;
    for (int n0 = 0; n0 < N; n0 += T::GW) {
      const int tiles = min(T::NT, (N - n0 + WG_N - 1) / WG_N);  // a slice's
      const bool live = nt < tiles;  // warpgroup-uniform
      int acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      for (int k0 = 0; k0 < K; k0 += WQ_K, tile += tiles) {
        // No branch around the products, as in run_chain_wgmma: a
        // warpgroup past the group's last column tile multiplies that
        // tile's stage too and writes nothing, and a k slice past K
        // multiplies zero weights.
        const unsigned t = tile + (live ? nt : tiles - 1);
        mbar_wait(&full[t % S], (t / S) & 1);
        const unsigned char* a = in + (k0 / WQ_K) * ROWS * 128 + mt * 64 * 128;
        const unsigned char* b = wbuf + (t % S) * WG_STAGE_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WQ_K / 32; ++kk)
          wgmma_64x128x32_s8(acc, sw128_desc(a + kk * 32),
                             sw128_desc(b + kk * 32));
        wgmma_commit();
        wgmma_wait<1>();
        __syncthreads();
        if (k0) refill(tile - tiles, tiles);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();
      refill(tile - tiles, tiles);

      // Epilogue, the activation a constant of each copy: the next
      // layer's codes into its swizzled buffer (over this layer's input
      // when in place: the sweep is done with it), or, in the last hidden
      // layer, the last dot's partial sums, one float per (row, 128-column
      // tile, half), in dst.
      if (live) {
        const int row = mt * 64 + (warp & 3) * 16 + (lane >> 2);
        const int col0 = n0 + nt * WG_N + 2 * (lane & 3);
        if (last) {
          float* sums = reinterpret_cast<float*>(dst);
          const int p0 = 2 * ((n0 + nt * WG_N) / WG_N);
#define LAST_GROUP(A)                                                       \
  last_group_int8<A>(acc, scale, beff, w_last, sums, row, col0, N, p0, n_part)
          switch (act) {
            case 1: LAST_GROUP(1); break;
            case 2: LAST_GROUP(2); break;
            case 3: LAST_GROUP(3); break;
            case 4: LAST_GROUP(4); break;
            default: LAST_GROUP(0);
          }
#undef LAST_GROUP
        } else {
#define STORE_GROUP(A)                                                      \
  store_group_int8<A, ROWS>(acc, scale, beff, inv_a, off, dst, row, col0, N)
          switch (act) {
            case 1: STORE_GROUP(1); break;
            case 2: STORE_GROUP(2); break;
            case 3: STORE_GROUP(3); break;
            case 4: STORE_GROUP(4); break;
            default: STORE_GROUP(0);
          }
#undef STORE_GROUP
        }
      }
      // The group's output is complete, and visible to the next layer's
      // products, before they read it.
      fence_proxy_async();
      __syncthreads();
    }
    if (dst != in) {
      other = in;
      in = dst;
    }
  }

  // ---- last layer: the one live column's dot, from the last hidden
  // layer's partial sums per row (in `in`), in order.
  const int n_part = 2 * ((ch.width[ch.n_hidden] + WG_N - 1) / WG_N);
  const float* sums = reinterpret_cast<const float*>(in);
  const float bias_last = b_last[0];
  for (int r = tid; r < ROWS; r += THREADS) {
    float s = 0.f;
    for (int p = 0; p < n_part; ++p) s = __fadd_rn(s, sums[r * n_part + p]);
    const int u = u0 + r / TC, c = c0 + r % TC;
    if (u < B && c < C)
      out[(size_t)u * C + c] = final_fn(__fadd_rn(s, bias_last), fin);
  }
}

// The block's chain in the int8 mode: the s8 wgmma chain (w_sw, the packed
// weights) where WG, run_chain_int8 (w) otherwise.
template <int TB, bool WG>
__device__ __forceinline__ void run_chain_int8_of(
    unsigned char* smem, const int8_t* __restrict__ w,
    const int8_t* __restrict__ w_sw, const float* __restrict__ qp,
    const float* __restrict__ w_last, const float* __restrict__ b_last,
    float* __restrict__ out, int B, int C, int u0, int c0, const WgChain& ch,
    int act, int fin) {
  static_assert(!WG || wgmma_rows<TB>(), "wgmma takes 64-row tiles");
  if constexpr (WG)
    run_chain_wgmma_int8<TB>(smem, w_sw, qp, w_last, b_last, out, B, C, u0,
                             c0, ch, act, fin);
  else
    run_chain_int8<TB>(smem, w, qp, w_last, b_last, out, B, C, u0, c0, ch,
                       act, fin);
}

// ---- host side

inline int round128(int x) { return (x + 127) / 128 * 128; }

// The s8 wgmma chain's layout for a block of `rows` (128 or 64) pair rows
// from the HOST array of n_hidden + 1 widths (each a positive multiple of
// 32, 1 <= n_hidden <= MAX_HIDDEN): the packed weights' byte offsets
// (layer l takes round128(K) x round64(N) bytes), qp's row offsets as in
// make_chain_int8, the layers in place (those whose output fits one
// group), the buffers' widths in bytes (multiples of 128) as strides,
// buffer A holding the first input and every later output that lands over
// it (the last hidden layer's partial sums, fewer bytes than its codes
// would take, where its codes would go), and as many ring stages as the
// shared memory left holds, at least two k slices' (4 at 128 rows, 8 at
// 64).
inline cudaError_t make_chain_wgmma_int8(int n_hidden, const int* wd,
                                         int rows, WgChain* ch) {
  *ch = WgChain{};
  if (n_hidden < 1 || n_hidden > MAX_HIDDEN || !wgmma_rows(rows))
    return cudaErrorInvalidValue;
  for (int l = 0; l <= n_hidden; ++l)
    if (wd[l] <= 0 || wd[l] % 32) return cudaErrorInvalidValue;
  ch->n_hidden = n_hidden;
  const int group = (4 / (rows / 64)) * WG_N;
  int cols[2] = {round128(wd[0]), 0}, cur = 0;
  long long w_off = 0;
  int b_off = QPARAM0;
  ch->width[0] = wd[0];
  for (int l = 0; l < n_hidden; ++l) {
    ch->width[l + 1] = wd[l + 1];
    ch->w_off[l] = w_off;
    ch->b_off[l] = b_off;
    w_off += (long long)round128(wd[l]) * round64(wd[l + 1]);
    b_off += 2 * wd[l + 1];
    if (wd[l + 1] <= group) ch->in_place |= 1u << l;
    else cur ^= 1;
    cols[cur] = cols[cur] > round128(wd[l + 1]) ? cols[cur]
                                                : round128(wd[l + 1]);
  }
  ch->stride_a = cols[0];
  ch->stride_b = cols[1];
  const long long left = (long long)WG_SMEM - WG_BARRIER_BYTES -
                         (long long)rows * (cols[0] + cols[1]);
  const long long fit = left / (long long)WG_STAGE_BYTES;
  const int least = 2 * (4 / (rows / 64));
  ch->stages = fit < least ? least : fit > WG_MAX_STAGES ? WG_MAX_STAGES : (int)fit;
  return cudaSuccess;
}

// Shared memory of an int8-mode block on either chain: on the s8 wgmma
// chain (ch.stages) the two code buffers, then the ring and its barriers
// or the assembly's `scratch` bytes, whichever is larger; on the mma.sync
// chain smem_bytes_int8.
inline size_t smem_bytes_int8_for(const WgChain& ch, size_t scratch,
                                  int rows) {
  if (!ch.stages) return smem_bytes_int8(ch, scratch, rows);
  const size_t ring = (size_t)ch.stages * WG_STAGE_BYTES + WG_BARRIER_BYTES;
  return (size_t)rows * (ch.stride_a + ch.stride_b) +
         (ring > scratch ? ring : scratch);
}

// The int8 chain of a block of `rows` pair rows by fit, in one fixed
// order: 128 rows on the s8 wgmma chain, 64 on the s8 wgmma chain, 64 on
// the mma.sync chain, 32, 16. A 64-row block whose s8 layout (its buffers
// and at least eight ring stages, the assembly's `scratch` bytes over the
// ring) passes WG_SMEM takes make_chain_int8's layout (ch->stages 0). The
// choice follows from the widths alone, so the launch and
// <name>_block_bytes make the same one; it is no retreat from a failure.
inline cudaError_t make_chain_fit_int8(int rows, int n_hidden, const int* wd,
                                       size_t scratch, WgChain* ch) {
  if (wgmma_rows(rows)) {
    const cudaError_t err = make_chain_wgmma_int8(n_hidden, wd, rows, ch);
    if (err != cudaSuccess || rows != 64 ||
        smem_bytes_int8_for(*ch, scratch, rows) <= (size_t)WG_SMEM)
      return err;
  }
  *ch = WgChain{};
  return make_chain_int8(n_hidden, wd, rows, ch);
}

}  // namespace pairwise

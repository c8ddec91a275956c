// pixelrec_multimodal_tpu_torch/ops/csrc/mlp_chain_wgmma.cuh
//
// The hidden Dense chain of mlp_chain.cuh on Hopper's warpgroup products
// (wgmma), for the bf16 modes of the pair kernels K1 (pairwise_mlp.cu), K2
// (gated_pairwise_mlp.cu) and K3 (gated_factored_mlp.cu), the attention
// kernels K4 (attention_mlp.cu) and K5 (attention_gram_mlp.cu) and the
// token-0 screen K6 (attention_screen_mlp.cu) at blocks of 128 and 64 pair
// rows (K1-K3 at 64 only where that block fits: make_chain_fit). At the
// flagship widths [512, 256, 128] a 128-row block takes 229,440 B: one
// 512-column buffer (131,072 B) that every layer writes over, six 16 KB
// stages and their barriers (98,368 B), the assembly's scratch within the
// ring. Its s8 form, in mlp_chain_wgmma_int8.cuh, runs the int8 modes of
// the pair kernels (K1q, K2q, K3q) at 128 and 64 rows on this header's
// descriptors, ring and weight stream (WeightStream<TB, int8_t>): an s8
// product reads 32 bytes of k as a bf16 one does, so a stage and a packed
// tile are the same bytes; probe P3 (probes/csrc/int8_mxu.cu) runs the
// same loop in both forms. It keeps run_chain's contract: the assembly's
// bf16 activations in buf_a, the epilogue's rounding points (an f32 bias
// add, one bf16 rounding, the activation on the bf16 pair), the
// warp-shuffle last dot, the scores into out. Blocks of 32 and 16 rows
// keep run_chain (wgmma takes 64-row tiles).
//
// Why: mma.sync fed by ldmatrix runs the chain's product loop at 174
// TFLOP/s bf16 (P3, 18% of the data sheet's 989); wgmma is the card's only
// way to its full tensor-core rate.
//
// Layout. Each activation buffer holds its ROWS pair rows in 64-column
// blocks of [ROWS][64] bf16, a row 128 bytes, its 16-byte chunks swizzled
// by the row (chunk ^ row % 8: the 128-byte swizzle of the wgmma
// descriptor, and no bank conflicts for the epilogue's stores), every block
// 1024-byte aligned. The chain's strides are the buffers' widths in
// columns, multiples of 64 (make_chain_wgmma), so buffer_b and ring place
// the buffers as for run_chain. The weights come packed by the host
// (ops/pairwise_mlp.py:wgmma_weights): per layer, W^T zero-padded to
// [N64, K64] (multiples of 64), cut into [64 n][64 k] tiles in the same
// swizzled layout, in the order (k slice, column group), so that the
// column groups of one k slice lie back to back.
//
// Product. The block's four warpgroups lie over a group of GW columns as
// MT = ROWS / 64 row tiles x NT = 4 / MT column tiles of 128 (128 rows:
// 2 x 2, GW 256; 64 rows: 1 x 4, GW 512); each issues wgmma.mma_async
// m64n128k16 (bf16 -> f32, 64 accumulators a thread), A and B from shared
// memory through K-major 128-byte-swizzle descriptors, four k16 steps per
// 64-row k slice, in the same order whatever the row count, and keeps one k
// slice's products in flight while the block releases the stages of the
// slice before. One sweep over K computes a group; a layer whose output
// fits one group writes it over its own input once the sweep is done (in
// place), which keeps the two buffers small: at the flagship, buffer A
// holds d and buffer B the rest. The weights stream through a ring of
// stages of one k slice x 128 columns (16 KB, one warpgroup column's B),
// as many as the shared memory left holds (up to WG_MAX_STAGES), each
// filled by one bulk copy of the tensor-memory accelerator (cp.async.bulk
// with an mbarrier; the tiles are contiguous, so no tensor map is needed)
// that thread 0 issues as soon as every warpgroup is done with the stage;
// its cursor runs ahead over groups and layers. No branch encloses a
// product (ptxas serializes wgmma in a divergent path), so a k slice past K
// multiplies zero pads and a warpgroup past a narrow layer's last column
// tile repeats that tile. The epilogue (store_group) writes the next
// layer's activations straight into the swizzled layout its A descriptor
// reads, then fences them for the async proxy. The assembly's scratch may
// overlay buffer B, the ring and its barriers, as in run_chain.
//
// Bound: the chain's tensor-core operations, 393,216 a pair at the
// flagship (0.834 ms at 989 TFLOP/s for a 256 x 8,192 block); the weights
// stream from L2, 384 KB a block.

#pragma once

#include "mlp_chain.cuh"

namespace pairwise {

constexpr int WG_K = 64;          // weight rows (k) per ring stage: one atom
constexpr int WG_N = 128;         // columns of a warpgroup's tile
constexpr int WG_STAGE = WG_N * WG_K;  // elements of a ring stage
constexpr int WG_MAX_STAGES = 8;  // stages in the ring, at most
constexpr int WG_BARRIER_BYTES = WG_MAX_STAGES * 8;  // after the ring
constexpr int WG_SMEM = 232448;   // shared memory a block may take (sm_90)

// Blocks that run the wgmma chain: 128 and 64 pair rows.
template <int TB>
__host__ __device__ constexpr bool wgmma_rows() {
  return TB >= 4;
}
inline bool wgmma_rows(int rows) { return rows >= 64; }

template <int TB>
struct WgTile {
  static_assert(TB == 4 || TB == 8, "wgmma takes blocks of 64 or 128 rows");
  static constexpr int ROWS = TB * TC;
  static constexpr int MT = ROWS / 64;     // row tiles of 64
  static constexpr int NT = 4 / MT;        // column tiles of 128
  static constexpr int GW = NT * WG_N;     // columns of a group (one sweep)
};

// The wgmma chain's layout: Chain's, plus the ring's stages and the layers
// that write their output over their input.
struct WgChain : Chain {
  int stages;
  unsigned in_place;  // bit l: layer l
};

// Element offset of (pair row r, column k) in a swizzled activation
// buffer of ROWS rows.
template <int ROWS>
__host__ __device__ __forceinline__ int sw_offset(int r, int k) {
  return (k >> 6) * (ROWS * 64) + r * 64 +
         ((((k >> 3) & 7) ^ (r & 7)) << 3) + (k & 7);
}

// ---- PTX wrappers

// K-major operand with the 128-byte swizzle: 8-row groups 1,024 bytes
// apart (the stride field); the leading offset is not read in this mode.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// The accumulators are not moved across the asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory before the async proxy (wgmma,
// bulk copies) reads or overwrites it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 128 f32, the m64nNk16 fragment: warp w of the warpgroup, lane l:
// d[4j + {0, 1}] at row 16w + l/4, columns 8j + 2(l%4) + {0, 1}; d[4j +
// {2, 3}] eight rows down) += A (64 x 16, desc a) x B (16 x 128, desc b).
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
      smem_addr(bar)), "r"(1));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` from global src into shared dst by the tensor-memory
// accelerator; the barrier's phase completes when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0's cursor over the weight stages, in the order the sweeps read
// them: layer, group, k slice, column tile (of 128: two packed tiles). E is
// the weights' type: a k slice is one 128-byte swizzle atom, 64 bf16 or 128
// int8 codes (the s8 chain of mlp_chain_wgmma_int8.cuh), and a packed tile
// 8 KB either way.
template <int TB, typename E = __nv_bfloat16>
struct WeightStream {
  using T = WgTile<TB>;
  static constexpr int KS = 128 / (int)sizeof(E);  // k of a slice
  static constexpr int TILE = 64 * KS;             // elements of a tile
  const E* w;
  int l = 0, n0 = 0, k0 = 0, p = 0;

  __device__ __forceinline__ bool more(const Chain& ch) const {
    return l < ch.n_hidden;
  }
  __device__ __forceinline__ void issue(const Chain& ch, void* dst,
                                        uint64_t* bar) {
    const int K = ch.width[l], N = ch.width[l + 1];
    const int groups = (N + 63) / 64, g = (n0 + p * WG_N) / 64;
    const int n = min(WG_N / 64, groups - g);
    bulk_load(dst, w + ch.w_off[l] + ((size_t)(k0 / KS) * groups + g) * TILE,
              (unsigned)(n * TILE * sizeof(E)), bar);
    if (++p * WG_N < min(T::GW, N - n0)) return;
    p = 0;
    if ((k0 += KS) < K) return;
    k0 = 0;
    if ((n0 += T::GW) < N) return;
    n0 = 0;
    ++l;
  }
};

// A warpgroup's share of a group's epilogue, for activation code ACT
// (act_fn's): + bf16 bias (f32 add), round to bf16, act, bf16, at (row,
// col0 + 8j) and eight rows down, and zeros in the pad columns up to a
// multiple of 64, which the next layer's last k slice reads. ACT is a
// constant, so act_pair's switch folds away in each of the 32 copies the
// unrolled stores make; with the code read at run time those copies held
// every activation's code, and the epilogue outgrew the instruction cache.
// The bias pairs of eight column chunks load together, not one after the
// other (a column past N reads the last pair).
template <int ACT, int ROWS>
__device__ __forceinline__ void store_group(const float (&acc)[64],
                                            const float* __restrict__ bl,
                                            __nv_bfloat16* dst, int row,
                                            int col0, int N) {
  const int n64 = (N + 63) / 64 * 64;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j0 = 0; j0 < 16; j0 += 8) {
    float2 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = __ldg(reinterpret_cast<const float2*>(
          bl + min(col0 + (j0 + j) * 8, N - 2)));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j0 + j) * 8, i = 4 * (j0 + j);
      if (col < n64) {
        const bool pad = col >= N;
        const __nv_bfloat162 top = __floats2bfloat162_rn(
            acc[i] + bv[j].x, acc[i + 1] + bv[j].y);
        const __nv_bfloat162 bot = __floats2bfloat162_rn(
            acc[i + 2] + bv[j].x, acc[i + 3] + bv[j].y);
        *reinterpret_cast<__nv_bfloat162*>(dst + sw_offset<ROWS>(row, col)) =
            pad ? zero : act_pair(top, ACT);
        *reinterpret_cast<__nv_bfloat162*>(
            dst + sw_offset<ROWS>(row + 8, col)) =
            pad ? zero : act_pair(bot, ACT);
      }
    }
  }
}

// run_chain on the wgmma chain: buf_a holds the assembled first-layer
// activations in the swizzled layout, w the packed weights; every thread
// has passed a __syncthreads since writing buf_a.
template <int TB>
__device__ __forceinline__ void run_chain_wgmma(
    __nv_bfloat16* buf_a, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ w_last,
    const float* __restrict__ b_last, float* __restrict__ out, int B, int C,
    int u0, int c0, const WgChain& ch, int act, int fin) {
  using T = WgTile<TB>;
  constexpr int ROWS = T::ROWS;
  const int S = ch.stages;
  __nv_bfloat16* wbuf = ring<TB>(buf_a, ch);
  uint64_t* full = reinterpret_cast<uint64_t*>(wbuf + S * WG_STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, mt = wg % T::MT, nt = wg / T::MT;

  WeightStream<TB> stream{w};
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s]);
    mbar_init_fence();
  }
  // Zeros in buffer A's pad columns, from the assembly's d up to a
  // multiple of 64, which the first layer's last k slice reads.
  {
    const int d = ch.width[0], pad = (d + 63) / 64 * 64 - d;
    for (int e = tid; e < ROWS * pad; e += THREADS)
      buf_a[sw_offset<ROWS>(e / pad, d + e % pad)] = __float2bfloat16_rn(0.f);
  }
  // The assembly's writes (buffer A, and its scratch where the ring now
  // lands) are ordered before the async proxy's reads and copies.
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S && stream.more(ch); ++s)
      stream.issue(ch, wbuf + s * WG_STAGE, &full[s]);
  // Thread 0 refills the n stages from tile t on, once every warpgroup is
  // done with them.
  auto refill = [&](unsigned t, int n) {
    if (tid == 0)
      for (int i = 0; i < n && stream.more(ch); ++i)
        stream.issue(ch, wbuf + ((t + i) % S) * WG_STAGE, &full[(t + i) % S]);
  };

  unsigned tile = 0;  // stages consumed: stage tile % S, its phase
  __nv_bfloat16* in = buf_a;
  __nv_bfloat16* other = buffer_b<TB>(buf_a, ch);
  for (int l = 0; l < ch.n_hidden; ++l) {
    const int K = ch.width[l], N = ch.width[l + 1];
    const float* bl = bias + ch.b_off[l];
    __nv_bfloat16* dst = (ch.in_place >> l) & 1 ? in : other;
    for (int n0 = 0; n0 < N; n0 += T::GW) {
      const int tiles = min(T::NT, (N - n0 + WG_N - 1) / WG_N);  // a slice's
      const bool live = nt < tiles;  // warpgroup-uniform
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int k0 = 0; k0 < K; k0 += WG_K, tile += tiles) {
        // No branch around the products (ptxas serializes wgmma in a
        // divergent path): a warpgroup past the group's last column tile
        // multiplies that tile's stage too and writes nothing, and a k
        // slice past K multiplies the zero pads of A and of the weights.
        const unsigned t = tile + (live ? nt : tiles - 1);
        mbar_wait(&full[t % S], (t / S) & 1);
        const __nv_bfloat16* a = in + (k0 / WG_K) * ROWS * 64 + mt * 64 * 64;
        const __nv_bfloat16* b = wbuf + (t % S) * WG_STAGE;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_K / 16; ++kk)
          wgmma_64x128x16(acc, sw128_desc(a + kk * 16),
                          sw128_desc(b + kk * 16));
        // One group of products per k slice in every warpgroup; the slice
        // before is done once at most this one is in flight.
        wgmma_commit();
        wgmma_wait<1>();
        __syncthreads();
        if (k0) refill(tile - tiles, tiles);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncthreads();
      refill(tile - tiles, tiles);

      // Epilogue: + bf16 bias (f32 add), round to bf16, act, bf16, into
      // the next layer's swizzled buffer (over this layer's input when in
      // place: the sweep is done with it), with the activation a constant
      // of each copy (store_group).
      if (live) {
        const int row = mt * 64 + (warp & 3) * 16 + (lane >> 2);
        const int col0 = n0 + nt * WG_N + 2 * (lane & 3);
        switch (act) {
          case 1: store_group<1, ROWS>(acc, bl, dst, row, col0, N); break;
          case 2: store_group<2, ROWS>(acc, bl, dst, row, col0, N); break;
          case 3: store_group<3, ROWS>(acc, bl, dst, row, col0, N); break;
          case 4: store_group<4, ROWS>(acc, bl, dst, row, col0, N); break;
          default: store_group<0, ROWS>(acc, bl, dst, row, col0, N);
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

  // ---- last layer: one live column, f32 dot per pair row, lanes over k
  // as in run_chain.
  const int hl = ch.width[ch.n_hidden];
  const float bias_last = b_last[0];
  for (int r = warp; r < ROWS; r += WARPS) {
    float s = 0.f;
    for (int k = lane; k < hl; k += 32)
      s += __bfloat162float(in[sw_offset<ROWS>(r, k)]) * w_last[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const int u = u0 + r / TC, c = c0 + r % TC;
      if (u < B && c < C) out[(size_t)u * C + c] = final_fn(s + bias_last, fin);
    }
  }
}

// The block's chain: run_chain_wgmma (w_sw, the packed weights) for 128
// and 64 rows, run_chain (w) below; WG false keeps run_chain at 64 rows
// too (a block whose wgmma layout does not fit: make_chain_fit).
template <int TB, bool WG = wgmma_rows<TB>()>
__device__ __forceinline__ void run_chain_of(
    __nv_bfloat16* buf_a, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ w_sw, const float* __restrict__ bias,
    const float* __restrict__ w_last, const float* __restrict__ b_last,
    float* __restrict__ out, int B, int C, int u0, int c0, const WgChain& ch,
    int act, int fin) {
  static_assert(!WG || wgmma_rows<TB>(), "wgmma takes 64-row tiles");
  if constexpr (WG)
    run_chain_wgmma<TB>(buf_a, w_sw, bias, w_last, b_last, out, B, C, u0, c0,
                        ch, act, fin);
  else
    run_chain<TB>(buf_a, w, bias, w_last, b_last, out, B, C, u0, c0, ch, act,
                  fin);
}

// ---- host side

inline int round64(int x) { return (x + 63) / 64 * 64; }

// Bytes of a ring stage.
constexpr size_t WG_STAGE_BYTES = (size_t)WG_STAGE * 2;

// make_chain for the wgmma chain of a block of `rows` (128 or 64) pair
// rows: the packed weights' offsets (layer l takes round64(K) x round64(N)
// elements); the layers in place (those whose output fits one group); the
// buffers' widths in columns (multiples of 64) as
// strides, buffer A holding the first input and every later output that
// lands over it; and as many ring stages as the shared memory left holds,
// at least two k slices' (4 at 128 rows, 8 at 64).
inline cudaError_t make_chain_wgmma(int n_hidden, const int* wd, int rows,
                                    WgChain* ch) {
  *ch = WgChain{};
  cudaError_t err = make_chain(n_hidden, wd, ch);
  if (err != cudaSuccess) return err;
  const int group = (4 / (rows / 64)) * WG_N;
  int cols[2] = {round64(wd[0]), 0}, cur = 0;
  long long w_off = 0;
  for (int l = 0; l < n_hidden; ++l) {
    ch->w_off[l] = w_off;
    w_off += (long long)round64(wd[l]) * round64(wd[l + 1]);
    if (wd[l + 1] <= group) ch->in_place |= 1u << l;
    else cur ^= 1;
    cols[cur] = cols[cur] > round64(wd[l + 1]) ? cols[cur] : round64(wd[l + 1]);
  }
  ch->stride_a = cols[0];
  ch->stride_b = cols[1];
  const long long left = (long long)WG_SMEM - WG_BARRIER_BYTES -
                         (long long)rows * (cols[0] + cols[1]) * 2;
  const long long fit = left / (long long)WG_STAGE_BYTES;
  // a k slice's stages, and the next slice's, while the slice before is
  // released
  const int least = 2 * (4 / (rows / 64));
  ch->stages = fit < least ? least : fit > WG_MAX_STAGES ? WG_MAX_STAGES : (int)fit;
  return cudaSuccess;
}

// The chain of a block of `rows` pair rows: the wgmma chain's layout for
// 128 and 64 rows, run_chain's below.
inline cudaError_t make_chain_for(int rows, int n_hidden, const int* wd,
                                  WgChain* ch) {
  if (wgmma_rows(rows)) return make_chain_wgmma(n_hidden, wd, rows, ch);
  *ch = WgChain{};
  return make_chain(n_hidden, wd, ch);
}

// Shared memory of a block on either chain (the wgmma chain's has ring
// stages, the mma.sync chain's none): the two activation buffers, then the
// ring (and, on the wgmma chain, its barriers) or the assembly's `scratch`
// bytes, whichever is larger.
inline size_t smem_bytes_for(const WgChain& ch, size_t scratch, int rows) {
  if (!ch.stages) return smem_bytes(ch, scratch, rows);
  const size_t ring = (size_t)ch.stages * WG_STAGE_BYTES + WG_BARRIER_BYTES;
  return (size_t)rows * (ch.stride_a + ch.stride_b) * 2 +
         (ring > scratch ? ring : scratch);
}

// make_chain_for with the blocks in one fixed order by fit: 128 rows on
// the wgmma chain, 64 on the wgmma chain, 64 on the mma.sync chain, 32, 16.
// A 64-row block whose wgmma layout (its buffers and at least two k slices'
// ring stages, with the assembly's `scratch` bytes over the ring) passes
// WG_SMEM takes the mma.sync chain's layout (ch->stages 0), as K1, K2 and
// K3 do for the wide chain [1024, 512, 256], whose 1,024-column buffer A
// leaves no room for the ring (262,208 B). The choice follows from the widths alone, so the
// launch and <name>_block_bytes make the same one; it is no retreat from a
// failure.
inline cudaError_t make_chain_fit(int rows, int n_hidden, const int* wd,
                                  size_t scratch, WgChain* ch) {
  const cudaError_t err = make_chain_for(rows, n_hidden, wd, ch);
  if (err != cudaSuccess || rows != 64 ||
      smem_bytes_for(*ch, scratch, rows) <= (size_t)WG_SMEM)
    return err;
  *ch = WgChain{};
  return make_chain(n_hidden, wd, ch);
}

// f(tb, wg) for the block of `rows` pair rows of a pair kernel (K1-K3 and
// their int8 modes): tb the tile's users (std::integral_constant<int, TB>,
// as dispatch_rows gives it), wg whether the block runs a wgmma chain
// (std::bool_constant; the s8 one of mlp_chain_wgmma_int8.cuh in the int8
// mode): never at 32 and 16 rows, always at 128, and at 64 where the
// layout chosen by fit says so (ch.stages: make_chain_fit, or
// make_chain_fit_int8 in the int8 mode).
template <typename F>
inline cudaError_t dispatch_chain(int rows, const WgChain& ch, F&& f) {
  return dispatch_rows(rows, [&](auto tb) -> cudaError_t {
    constexpr int TB = decltype(tb)::value;
    if constexpr (!wgmma_rows<TB>())
      return f(tb, std::false_type());
    else if constexpr (TB == 4)
      return ch.stages ? f(tb, std::true_type()) : f(tb, std::false_type());
    else
      return f(tb, std::true_type());
  });
}

// 2: the block of `rows` pair rows runs the wgmma chain, 1: the mma.sync
// chain of mlp_chain.cuh; a negative CUDA error for rows no kernel is built
// for.
inline int chain_kind(int rows) {
  return !valid_rows(rows) ? -(int)cudaErrorInvalidValue
                           : wgmma_rows(rows) ? 2 : 1;
}

}  // namespace pairwise

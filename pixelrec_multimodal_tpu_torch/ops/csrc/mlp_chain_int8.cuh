// pixelrec_multimodal_tpu_torch/ops/csrc/mlp_chain_int8.cuh
//
// The int8 mode of the pair-scoring kernels (K1q in pairwise_mlp.cu, K2q in
// gated_pairwise_mlp.cu, K3q in gated_factored_mlp.cu): each kernel
// assembles its first-layer activations as in its bf16 mode, rounds them to
// bf16 where that mode does, and ends the assembly by quantizing them into
// int8 codes in buf_a; run_chain_int8 then runs the quantized hidden chain
// and the last layer on mma.sync, in blocks of 32 and 16 rows and in a
// 64-row block whose s8 wgmma layout does not fit. At 128 and 64 rows the
// three kernels run the s8 wgmma chain of mlp_chain_wgmma_int8.cuh, which
// keeps this chain's contract, its codes and its 128-row block's float32
// order in the last dot. Bound on this card: P3 measured this product loop
// at 329 TOP/s, a sixth of the data sheet's 1,979 and no faster than the
// bf16 wgmma chain; that is why the larger blocks left it.
//
// Counterpart of pixelrec_multimodal_tpu/ops/pairwise_mlp.py:_quantize_rows
// and _mlp_chain_int8 (quantize_mlp_chain builds the operands):
//   for each hidden Dense l (wq [K, N] int8, out_scale, bias_eff [N], and
//   the scalars inv_a, off of its input):
//        q = clamp(floor(x * inv_a + off), -128, 127)     codes of the input
//        x = act(f32(q @ wq) * out_scale + bias_eff)      int32 sums, f32 out
//   s  = sum_k x[k] * w_last[k, 0] + b_last[0]   (f32; w_last unrounded),
//        then the final activation.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn), as the
// plain version rounds them: a fused multiply-add would move values that lie
// within an ulp of a code boundary to the neighbouring code. Layer 0's
// input is the bf16-rounded assembly, upcast; after that nothing is rounded
// to bf16. Each hidden layer's epilogue quantizes its output with the next
// layer's (inv_a, off), so the activation buffers hold int8 codes; the last
// hidden layer's epilogue takes its f32 output straight into the last dot
// (per-row partial sums, added in a fixed order), so no f32 activation
// buffer is kept and a block of small widths leaves room for others on
// its SM.
//
// Block shape and tiling are run_chain's (mlp_chain.cuh): 16 warps, TB
// users x 16 items (128, 64, 32 or 16 pair rows), the warps over each
// 128-column pass as TB row groups x 16 / TB column groups, weights through
// a three-slice cp.async ring. The products run on the tensor cores as
// mma.sync m16n8k32 s8 x s8 -> s32 (twice the bf16 operations per
// instruction). ldmatrix moves 16-bit elements only, and the B operand must
// be K-contiguous per output column, so the weights are kept transposed,
// [N, K] (ops/pairwise_mlp.py:_kernel_chain_int8), and loaded without .trans;
// the A operand (row-major codes) loads as ldmatrix .b16 x4, two codes per
// element. The int32 sums are exact (|sum| <= K * 128 * 127). The last
// dot's partial sums are per (row, pass, column group), so its order of
// float32 additions, unlike the hidden layers', depends on the row count.
//
// Operands: w holds every layer's wq^T [N, K] back to back; qp (the
// kernels' `bias` argument) holds (inv_a, off) of layer l at qp[2l], qp[2l+1]
// in QPARAM0 = 2 * MAX_HIDDEN slots, then out_scale [N] and bias_eff [N] of
// each layer from ch.b_off[l]. Widths are multiples of 32 (the depth of one
// product), 1 to MAX_HIDDEN hidden layers.

#pragma once

#include <type_traits>

#include "mlp_chain.cuh"

namespace pairwise {

constexpr int KSQ = 64;                // weight bytes (k) per slice row
constexpr int QPAD = 16;               // byte padding of int8 rows
constexpr int QWSTRIDE = KSQ + QPAD;   // bytes per output column of a slice
constexpr int QPARAM0 = 2 * MAX_HIDDEN;  // (inv_a, off) slots before the rows

// The weight element type of a kernel's mode.
template <bool Q>
using Weight = std::conditional_t<Q, int8_t, __nv_bfloat16>;

// The code of x: clamp(floor(x * inv_a + off), -128, 127), each step
// rounded as the plain version rounds it.
__device__ __forceinline__ int quantize(float x, float inv_a, float off) {
  const int q = __float2int_rd(__fadd_rn(__fmul_rn(x, inv_a), off));
  return min(max(q, -128), 127);
}
// Four bf16 values (as an assembly stores them) -> four codes, element 0 in
// the lowest byte.
__device__ __forceinline__ uint32_t quantize_bf16x4(uint2 v, float inv_a,
                                                    float off) {
  const float2 lo = __bfloat1622float2(as_bf162(v.x));
  const float2 hi = __bfloat1622float2(as_bf162(v.y));
  return (uint32_t)(quantize(lo.x, inv_a, off) & 0xff) |
         ((uint32_t)(quantize(lo.y, inv_a, off) & 0xff) << 8) |
         ((uint32_t)(quantize(hi.x, inv_a, off) & 0xff) << 16) |
         ((uint32_t)(quantize(hi.y, inv_a, off) & 0xff) << 24);
}

// c[0..1]: row lane/4, columns 2*(lane%4) + {0, 1}; c[2..3]: row lane/4 + 8.
// a: the 16x32 code tile as four 8x16-byte matrices (rows 0-7 | 8-15) x
// (bytes 0-15 | 16-31); b0, b1: column lane/4, k bytes 0-15 | 16-31.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Output columns [n0, n0 + NB) x bytes [k0, k0 + KSQ) of a [N, K] int8
// matrix into an [NB, QWSTRIDE] slice; columns past N and bytes past K are
// not loaded (the products that would read them are skipped).
__device__ __forceinline__ void load_slice_int8(const int8_t* __restrict__ W,
                                                int K, int N, int k0, int n0,
                                                int8_t* dst) {
  const int rows = min(NB, N - n0);
  const int vec = min(KSQ, K - k0) / 16;
  for (int e = threadIdx.x; e < rows * vec; e += THREADS) {
    const int r = e / vec, v = e - r * vec;
    cp_async16(dst + r * QWSTRIDE + v * 16,
               W + (size_t)(n0 + r) * K + k0 + v * 16);
  }
}

// Shared memory of an int8-mode block, in bytes: the two activation buffers
// (row strides ch.stride_a, ch.stride_b in bytes), then the weight ring,
// which first holds the assembly's scratch.
template <int TB>
__host__ __device__ __forceinline__ unsigned char* ring_int8(
    unsigned char* smem, const Chain& ch) {
  return smem + Tile<TB>::ROWS * (ch.stride_a + ch.stride_b);
}
// The assembly's scratch of either mode (the start of the weight ring).
template <bool Q, int TB>
__device__ __forceinline__ unsigned char* scratch_of(unsigned char* smem,
                                                     const Chain& ch) {
  if constexpr (Q) {
    return ring_int8<TB>(smem, ch);
  } else {
    return reinterpret_cast<unsigned char*>(
        ring<TB>(reinterpret_cast<__nv_bfloat16*>(smem), ch));
  }
}

// One 128-column pass of an int8 Dense on the tensor cores: acc (zero on
// entry) += in[rows, :K] @ W^T[:K, n0 : n0 + NB] (codes, W kept [N, K]) for
// the warp's 16 rows and NT n8 tiles, exact int32 sums, the weights through
// the ring at wbuf. Every thread calls it; the caller's epilogue ends with
// a __syncthreads before the ring is loaded again.
template <int TB>
__device__ __forceinline__ void chain_pass_int8(
    const int8_t* in, int in_stride, const int8_t* __restrict__ W, int K,
    int N, int n0, int8_t* wbuf, int (&acc)[Tile<TB>::NT][4]) {
  using T = Tile<TB>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % T::RG, wc = warp / T::RG;
  const int nk = (K + KSQ - 1) / KSQ;
  // The ring as in chain_pass: every iteration commits one (possibly
  // empty) group, so "all but the newest STAGES-2 groups are done" means
  // slice s has landed.
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk) load_slice_int8(W, K, N, p * KSQ, n0, wbuf + p * NB * QWSTRIDE);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = s + STAGES - 1;
    if (nxt < nk)
      load_slice_int8(W, K, N, nxt * KSQ, n0,
                      wbuf + (nxt % STAGES) * NB * QWSTRIDE);
    cp_async_commit();
    const int8_t* ws = wbuf + (s % STAGES) * NB * QWSTRIDE;
    for (int kk = 0; kk < KSQ && s * KSQ + kk < K; kk += 32) {
      uint32_t a[4];
      ldmatrix_x4(a, in + (wr * 16 + (lane & 15)) * in_stride + s * KSQ + kk +
                         (lane >> 4) * 16);
      if constexpr (T::NT >= 2) {
#pragma unroll
        for (int jp = 0; jp < T::NT / 2; ++jp) {
          const int col = wc * T::WN + jp * 16;
          if (n0 + col < N) {
            // lanes 0-7: columns 0-7, bytes 0-15; 8-15: columns 0-7,
            // bytes 16-31; 16-23 and 24-31: columns 8-15.
            uint32_t b[4];
            ldmatrix_x4(b, ws + (col + (lane & 7) + ((lane >> 4) << 3)) *
                                    QWSTRIDE +
                               kk + ((lane >> 3) & 1) * 16);
            mma_s8(acc[2 * jp], a, b[0], b[1]);
            mma_s8(acc[2 * jp + 1], a, b[2], b[3]);
          }
        }
      } else {
        const int col = wc * T::WN;
        if (n0 + col < N) {
          uint32_t b[2];
          ldmatrix_x2(b, ws + (col + (lane & 7)) * QWSTRIDE + kk +
                             ((lane >> 3) & 1) * 16);
          mma_s8(acc[0], a, b[0], b[1]);
        }
      }
    }
  }
}

// The int8 hidden chain and the last layer on the block's ROWS pair rows:
// buf_a (at smem) holds layer 0's input codes, row stride ch.stride_a
// bytes, and every thread has passed a __syncthreads since writing them.
// Row r is user u0 + r / TC, item c0 + r % TC; only rows inside [B, C] are
// written to out.
template <int TB>
__device__ __forceinline__ void run_chain_int8(
    unsigned char* smem, const int8_t* __restrict__ w,
    const float* __restrict__ qp, const float* __restrict__ w_last,
    const float* __restrict__ b_last, float* __restrict__ out, int B, int C,
    int u0, int c0, const Chain& ch, int act, int fin) {
  using T = Tile<TB>;
  int8_t* buf_a = reinterpret_cast<int8_t*>(smem);
  int8_t* buf_b = buf_a + T::ROWS * ch.stride_a;
  int8_t* wbuf = reinterpret_cast<int8_t*>(ring_int8<TB>(smem, ch));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Warp (wr, wc) owns rows [wr * 16, +16) and columns [wc * WN, +WN) of
  // each pass.
  const int wr = warp % T::RG, wc = warp / T::RG;
  const int g = lane >> 2, t = lane & 3;
  int8_t* in = buf_a;
  int in_stride = ch.stride_a;
  int8_t* dst = buf_b;
  int dst_stride = ch.stride_b;

  for (int l = 0; l < ch.n_hidden; ++l) {
    const int K = ch.width[l], N = ch.width[l + 1];
    const int8_t* W = w + ch.w_off[l];
    const float* scale = qp + ch.b_off[l];
    const float* beff = scale + N;
    const bool last = l == ch.n_hidden - 1;
    // the next layer's quantize (the last hidden layer feeds the last dot)
    const float inv_a = last ? 0.f : qp[2 * (l + 1)];
    const float off = last ? 0.f : qp[2 * (l + 1) + 1];
    for (int n0 = 0; n0 < N; n0 += NB) {
      int acc[T::NT][4];
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0;
      chain_pass_int8<TB>(in, in_stride, W, K, N, n0, wbuf, acc);

      // Epilogue on the accumulators: act(f32(acc) * out_scale +
      // bias_eff), then the next layer's codes; in the last hidden layer,
      // each value times its w_last entry instead, summed per row: over
      // the thread's columns in order, then over the quad's four threads.
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int col = n0 + wc * T::WN + j * 8 + 2 * t;
        if (n0 + wc * T::WN + j * 8 < N) {
          const float s0 = scale[col], s1 = scale[col + 1];
          const float e0 = beff[col], e1 = beff[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wr * 16 + g + 8 * h;
            const float v0 = act_fn(
                __fadd_rn(__fmul_rn(__int2float_rn(acc[j][2 * h]), s0), e0),
                act);
            const float v1 = act_fn(
                __fadd_rn(__fmul_rn(__int2float_rn(acc[j][2 * h + 1]), s1),
                          e1),
                act);
            if (last) {
              part[h] = __fadd_rn(part[h], __fmul_rn(v0, w_last[col]));
              part[h] = __fadd_rn(part[h], __fmul_rn(v1, w_last[col + 1]));
            } else {
              *reinterpret_cast<uint16_t*>(dst + row * dst_stride + col) =
                  (uint16_t)((quantize(v0, inv_a, off) & 0xff) |
                             ((quantize(v1, inv_a, off) & 0xff) << 8));
            }
          }
        }
      }
      if (last) {
        // The warp's share of rows g and g + 8 over its WN columns of the
        // pass, one float per (row, pass, column group) in dst.
        float* sums = reinterpret_cast<float*>(dst);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          part[h] =
              __fadd_rn(part[h], __shfl_xor_sync(0xffffffffu, part[h], 1));
          part[h] =
              __fadd_rn(part[h], __shfl_xor_sync(0xffffffffu, part[h], 2));
          if (t == 0)
            sums[(wr * 16 + g + 8 * h) * (dst_stride / 4) +
                 T::CG * (n0 / NB) + wc] = part[h];
        }
      }
      // The layer output is complete before it is read, and every warp is
      // done with the ring before the next pass loads it.
      __syncthreads();
    }
    int8_t* t_in = in;
    in = dst;
    dst = t_in;
    const int ts = in_stride;
    in_stride = dst_stride;
    dst_stride = ts;
  }

  // ---- last layer: the one live column's dot, from the last hidden
  // layer's partial sums per row (in `in` after the swap), in order.
  const int n_part = T::CG * ((ch.width[ch.n_hidden] + NB - 1) / NB);
  const float* sums = reinterpret_cast<const float*>(in);
  const float bias_last = b_last[0];
  for (int r = tid; r < T::ROWS; r += THREADS) {
    float s = 0.f;
    for (int p = 0; p < n_part; ++p)
      s = __fadd_rn(s, sums[r * (in_stride / 4) + p]);
    const int u = u0 + r / TC, c = c0 + r % TC;
    if (u < B && c < C)
      out[(size_t)u * C + c] = final_fn(__fadd_rn(s, bias_last), fin);
  }
}

// ---- host side

// The int8 chain's layout for a block of `rows` pair rows from the HOST
// array of n_hidden + 1 widths (each a positive multiple of 32, 1 <=
// n_hidden <= MAX_HIDDEN): weight offsets in bytes, row offsets into qp,
// buffer strides in bytes. Layer l's input codes live in buffer l % 2; the
// last hidden layer's partial sums of the last dot (one float per 128-column
// pass and column group, 256 / rows groups) in buffer n_hidden % 2. Rows
// are padded by QPAD bytes to a stride of 16 modulo 32: the eight 16-byte
// rows an ldmatrix reads fall in distinct banks.
inline cudaError_t make_chain_int8(int n_hidden, const int* wd, int rows,
                                   Chain* ch) {
  if (n_hidden < 1 || n_hidden > MAX_HIDDEN || !valid_rows(rows))
    return cudaErrorInvalidValue;
  *ch = Chain{};
  ch->n_hidden = n_hidden;
  const int groups = WARPS / (rows / 16);  // column groups of a pass
  int bytes[2] = {0, 0};
  long long w_off = 0;
  int b_off = QPARAM0;
  for (int l = 0; l <= n_hidden; ++l) {
    if (wd[l] <= 0 || wd[l] % 32) return cudaErrorInvalidValue;
    ch->width[l] = wd[l];
    const int sums = 4 * groups * ((wd[l] + NB - 1) / NB);  // partial sums
    const int row = (l < n_hidden ? wd[l] : (sums + 31) / 32 * 32) + QPAD;
    bytes[l % 2] = row > bytes[l % 2] ? row : bytes[l % 2];
    if (l < n_hidden) {
      ch->w_off[l] = w_off;
      ch->b_off[l] = b_off;
      w_off += (long long)wd[l] * wd[l + 1];
      b_off += 2 * wd[l + 1];
    }
  }
  ch->stride_a = bytes[0];
  ch->stride_b = bytes[1];
  return cudaSuccess;
}

// Two activation buffers of `rows` pair rows plus the weight ring, which
// first holds `scratch` bytes of the assembly's data.
inline size_t smem_bytes_int8(const Chain& ch, size_t scratch, int rows) {
  const size_t ring = (size_t)STAGES * NB * QWSTRIDE;
  return (size_t)rows * (ch.stride_a + ch.stride_b) +
         (ring > scratch ? ring : scratch);
}

}  // namespace pairwise

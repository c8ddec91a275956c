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
// then the hidden chain and the last dot, as K1's. T is the item-major table
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
// Design: K1's block shape and chains (pairwise_mlp.cu; K2's layout):
// the wgmma chain of mlp_chain_wgmma.cuh at 128 and 64 rows where that
// block fits (229,440 B at the flagship widths), the mma.sync chain of
// mlp_chain.cuh below. On the TPU the point of the factored form was to
// move the assembly onto the matrix unit; here the contraction has K = Mi
// <= 7 and is written as multiplies and adds on the CUDA cores, which cost
// no more than the exact kernel's weighted sum. What the factored form
// saves on this card is bytes: the item tables are bf16, half of the exact
// kernel's f32 parts, and the per-pair softmax becomes a Mi-term dot
// product. Each thread loads the Mi 4-column bf16 slots of one item once
// (8 bytes each) and combines them with all the tile's users. The tile's
// f32 user rows, its bf16-rounded coefficients and the per-pair (p0, 1/Z)
// (pair_coefs), 17,664 B at 128 rows, live in the weight ring until the
// chain starts. Every product and sum of the assembly is unfused
// (__fmul_rn, __fadd_rn) and in the plain version's order, so that both
// round the same f32 values to bf16.
//
// int8 mode (K3q, the template flag Q): the same assembly, each bf16
// activation then quantized with layer 0's (inv_a, off) into an int8 code,
// and K2q's int8 chains: the s8 wgmma chain of mlp_chain_wgmma_int8.cuh at
// 128 rows and at 64 where that block fits (196,672 B at the flagship),
// the mma.sync chain of mlp_chain_int8.cuh below. Like K2q, bound by its
// f32 operations rather than its int8 products, which the s8 wgmma chain
// takes off the critical path.

#include "mlp_chain_int8.cuh"
#include "mlp_chain_wgmma.cuh"
#include "mlp_chain_wgmma_int8.cuh"

namespace {

using namespace pairwise;

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 v) {
  const float2 lo = __bfloat1622float2(as_bf162(v.x));
  const float2 hi = __bfloat1622float2(as_bf162(v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The tile's bf16-rounded user coefficients (as f32) into coef [TB,
// GATE_PAD], and each pair row's (p0, 1/Z) into row_z [ROWS] (row r: user
// u0 + r / TC, item c0 + r % TC), from the unrounded a and igb; rows past B
// or C take zero coefficients.
template <int TB>
__device__ __forceinline__ void pair_coefs(const float* __restrict__ a,
                                           const float* __restrict__ igb,
                                           float* coef, float2* row_z, int B,
                                           int C, int u0, int c0, int n_mod) {
  const int tid = threadIdx.x;
  for (int e = tid; e < TB * GATE_PAD; e += THREADS) {
    const int bu = e / GATE_PAD, m = e % GATE_PAD;
    coef[e] = (u0 + bu < B && m < n_mod)
                  ? __bfloat162float(__float2bfloat16_rn(
                        a[(size_t)(u0 + bu) * GATE_PAD + m]))
                  : 0.f;
  }
  for (int r = tid; r < Tile<TB>::ROWS; r += THREADS) {
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
}

// WG: the mode's wgmma chain (bf16 or s8, at 128 and 64 rows, by fit),
// else its mma.sync chain.
template <bool Q, int TB, bool WG>
__global__ void __launch_bounds__(THREADS)
gated_factored_kernel(const float* __restrict__ uf, const float* __restrict__ a,
                      const __nv_bfloat16* __restrict__ T,
                      const float* __restrict__ igb,
                      const Weight<Q>* __restrict__ w_sw,
                      const Weight<Q>* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ w_last,
                      const float* __restrict__ b_last,
                      float* __restrict__ out, int B, int C, int n_mod,
                      WgChain ch, int act, int fin) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);

  const int c0 = blockIdx.x * TC, u0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const int h1 = ch.width[0];
  const int q = h1 / 4;
  const int n_item = n_mod - 1;

  // Scratch in the ring: the tile's f32 user rows, their bf16-rounded
  // coefficients (as f32) and each pair row's (p0, 1/Z). Rows past B or C
  // have zero coefficients or tables, assemble to zeros and are never
  // written out. The wgmma chain's first bulk copies and barriers come
  // after the __syncthreads that ends the assembly, once every read of the
  // scratch is done (run_chain_wgmma).
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
  pair_coefs<TB>(a, igb, coef, row_z, B, C, u0, c0, n_mod);
  // int8 mode: layer 0's (inv_a, off), bias[0] and bias[1]
  float inv_a = 0.f, off = 0.f;
  if constexpr (Q) {
    inv_a = bias[0];
    off = bias[1];
  }
  __syncthreads();

  // ---- assembly: buf_a[bu * TC + ci] = bf16(act((p0 * u + r) / Z))
  // (int8 mode: its codes; wgmma chain: at its swizzled offset, the four
  // values of a store inside one 16-byte chunk).
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
      if constexpr (Q && WG) {
        *reinterpret_cast<uint32_t*>(
            smem + sw_byte_offset<Tile<TB>::ROWS>(r, k)) =
            quantize_bf16x4(act_to_bf16x4(x, act), inv_a, off);
      } else if constexpr (Q) {
        *reinterpret_cast<uint32_t*>(smem + r * ch.stride_a + k) =
            quantize_bf16x4(act_to_bf16x4(x, act), inv_a, off);
      } else if constexpr (WG) {
        *reinterpret_cast<uint2*>(buf_a + sw_offset<Tile<TB>::ROWS>(r, k)) =
            act_to_bf16x4(x, act);
      } else {
        *reinterpret_cast<uint2*>(buf_a + r * ch.stride_a + k) =
            act_to_bf16x4(x, act);
      }
    }
  }
  __syncthreads();
  if constexpr (Q) {
    run_chain_int8_of<TB, WG>(smem, w, w_sw, bias, w_last, b_last, out, B,
                              C, u0, c0, ch, act, fin);
  } else {
    run_chain_of<TB, WG>(buf_a, w, w_sw, bias, w_last, b_last, out, B, C, u0,
                         c0, ch, act, fin);
  }
}

// The assembly's scratch in the ring (see the kernel).
inline size_t scratch_bytes(int h1, int rows) {
  return ((size_t)(rows / TC) * (h1 + GATE_PAD) + 2 * (size_t)rows) * 4;
}

// The chain of a block of `rows` pair rows in either mode, from the HOST
// width array: the int8 layout (K3q, mma.sync), or the bf16 chain by fit
// (make_chain_fit: wgmma at 128 and 64 rows where its block fits); and the
// block's shared memory.
template <bool Q>
inline cudaError_t block_chain(int n_hidden, const void* widths, int rows,
                               WgChain* ch) {
  *ch = WgChain{};
  if (!valid_rows(rows)) return cudaErrorInvalidValue;
  const int* wd = static_cast<const int*>(widths);
  const size_t scratch = scratch_bytes(wd[0], rows);
  return Q ? make_chain_fit_int8(rows, n_hidden, wd, scratch, ch)
           : make_chain_fit(rows, n_hidden, wd, scratch, ch);
}
template <bool Q>
inline size_t block_smem(const WgChain& ch, int rows) {
  const size_t scratch = scratch_bytes(ch.width[0], rows);
  return Q ? smem_bytes_int8_for(ch, scratch, rows)
           : smem_bytes_for(ch, scratch, rows);
}

template <bool Q, int TB, bool WG>
cudaError_t launch(const void* uf, const void* a, const void* T,
                   const void* igb, const void* w_sw, const void* w,
                   const void* bias, const void* w_last, const void* b_last,
                   void* out, int B, int C, int n_mod, const WgChain& ch,
                   int act, int fin, int rows, cudaStream_t stream) {
  const size_t smem = block_smem<Q>(ch, rows);
  dim3 grid;
  const cudaError_t err = prepare_launch(gated_factored_kernel<Q, TB, WG>,
                                         smem, B, C, rows, &grid);
  if (err != cudaSuccess) return err;
  gated_factored_kernel<Q, TB, WG><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(uf), static_cast<const float*>(a),
      static_cast<const __nv_bfloat16*>(T), static_cast<const float*>(igb),
      static_cast<const Weight<Q>*>(w_sw),
      static_cast<const Weight<Q>*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(w_last), static_cast<const float*>(b_last),
      static_cast<float*>(out), B, C, n_mod, ch, act, fin);
  return cudaGetLastError();
}

template <bool Q>
int forward(const void* uf, const void* a, const void* T, const void* igb,
            const void* w_sw, const void* w, const void* bias,
            const void* w_last, const void* b_last, void* out, int B, int C,
            int n_hidden, const void* widths, int act, int fin, int n_mod,
            int rows, void* stream) {
  if (n_mod < 2 || n_mod > GATE_PAD) return cudaErrorInvalidValue;
  WgChain ch;
  const cudaError_t err = block_chain<Q>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_chain(rows, ch, [&](auto tb, auto wg) {
    return launch<Q, decltype(tb)::value, decltype(wg)::value>(
        uf, a, T, igb, w_sw, w, bias, w_last, b_last, out, B, C, n_mod, ch,
        act, fin, rows, s);
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from user_first [B, h1] and the user
// coefficients a [B, GATE_PAD] (f32, 16-byte aligned rows), the item
// tables T [C, Mi, h1] (bf16, 8-byte aligned) and igb [C, GATE_PAD] (f32);
// only the first n_mod coefficient columns are read (2 <= n_mod <=
// GATE_PAD, Mi = n_mod - 1). The chain arguments (w_sw, w, bias, w_last,
// b_last, n_hidden, widths, act, fin) are pairwise_mlp_forward's: w_sw the
// hidden weights packed for the wgmma chain, read in the blocks that run
// it. Returns cudaSuccess or the first CUDA error (launch included); a
// block that does not fit in shared memory returns cudaErrorInvalidValue;
// rows is the block's pair rows (128, 64, 32 or 16:
// ops/pairwise_mlp.py:block_rows).
int gated_factored_mlp_forward(const void* uf, const void* a, const void* T,
                               const void* igb, const void* w_sw,
                               const void* w, const void* bias,
                               const void* w_last, const void* b_last,
                               void* out, int B, int C, int n_hidden,
                               const void* widths, int act, int fin,
                               int n_mod, int rows, void* stream) {
  return forward<false>(uf, a, T, igb, w_sw, w, bias, w_last, b_last, out, B,
                        C, n_hidden, widths, act, fin, n_mod, rows, stream);
}

// The int8 mode (K3q): the arguments of gated_factored_mlp_forward, with the
// chain arguments of pairwise_mlp_int8_forward and w_sw the quantized
// weights packed for the s8 wgmma chain (ops/pairwise_mlp.py:wgmma_weights
// of the int8 chain), read in the blocks that run it: 128 rows, and 64
// where that block fits (make_chain_fit_int8); the int8 mma.sync chain
// below.
int gated_factored_mlp_int8_forward(const void* uf, const void* a,
                                    const void* T, const void* igb,
                                    const void* w_sw, const void* w,
                                    const void* bias, const void* w_last,
                                    const void* b_last, void* out, int B, int C,
                                    int n_hidden, const void* widths, int act,
                                    int fin, int n_mod, int rows, void* stream) {
  return forward<true>(uf, a, T, igb, w_sw, w, bias, w_last, b_last, out,
                       B, C, n_hidden, widths, act, fin, n_mod, rows, stream);
}

// Shared memory a block of `rows` pair rows takes in either mode (int8 != 0:
// K3q), as the launch set-up counts it (on the chain make_chain_fit or
// make_chain_fit_int8 chooses); a negative CUDA error for widths or rows
// the kernel does not take.
int gated_factored_mlp_block_bytes(int n_hidden, const void* widths, int int8,
                                   int rows) {
  WgChain ch;
  const cudaError_t err = int8 ? block_chain<true>(n_hidden, widths, rows, &ch)
                               : block_chain<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  return (int)(int8 ? block_smem<true>(ch, rows) : block_smem<false>(ch, rows));
}

// The chain a block of `rows` pair rows of the bf16 mode runs where its
// wgmma block fits: 2 wgmma (128, 64), 1 mma.sync (32, 16).
int gated_factored_mlp_chain_kind(int rows) { return chain_kind(rows); }

// The chain a block of `rows` pair rows runs on these widths, in either
// mode (int8 != 0: K3q), as chosen by fit (make_chain_fit,
// make_chain_fit_int8): 2 a wgmma chain (bf16, or s8 in the int8 mode), 1
// mma.sync; a negative CUDA error for widths or rows the kernel does not
// take.
int gated_factored_mlp_block_chain_kind(int n_hidden, const void* widths,
                                        int int8, int rows) {
  WgChain ch;
  const cudaError_t err = int8 ? block_chain<true>(n_hidden, widths, rows, &ch)
                               : block_chain<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  return ch.stages ? 2 : 1;
}

}  // extern "C"

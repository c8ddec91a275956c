// pixelrec_multimodal_tpu_torch/ops/csrc/gated_pairwise_mlp.cu
//
// Fused gated-fusion pair scoring for Hopper (sm_90a), exact variant: one
// launch scores a [B users] x [C items] block through the factorized,
// BatchNorm-folded gated head and writes the [B, C] f32 score matrix.
//
// Replaces: pixelrec_multimodal_tpu/ops/pairwise_mlp.py:_gated_pairwise_kernel
// (bf16 mode, reached through pallas_pairwise_scores_gated), and, as
// gated_pairwise_mlp_int8_forward, the same kernel's int8 mode (n_quant > 0:
// K2q).
//
// What it computes, per (user b, item c) pair, with M = n_mod modalities
// (the user, then Mi = M - 1 item-side ones), all in f32:
//   l_m = ug[b, m] + ig[c, m]  (m < M; the GATE_PAD - M padding columns
//         never enter the softmax)
//   g_m = e_m * (1 / sum e),  e_m = exp(l_m - max l)
//   x   = g_0 * uf[b] + sum_{m=1..Mi} g_m * itf[c, (m-1)*h1 : m*h1]
//         (b1 is folded into every part: the gates sum to 1)
//   x   = bf16(act(x))  -- the one bf16 rounding of the assembly
// then the hidden chain and the last dot, as K1's. Unlike K1
// (pairwise_mlp.cu) the user and item parts are not rounded to bf16 before
// they are combined.
// The module's pairwise_scores_gated_plain(compute_dtype=bfloat16) repeats
// these rounding points on tensors.
//
// Bound: per pair at the flagship head (h1 512 -> 256 -> 128 -> 1, M = 6)
// the hidden products are 2*512*256 + 2*256*128 = 327,680 tensor-core
// operations; the assembly is about 2*M*h1 + h1 + 6*M = 6,692 f32
// operations (the weighted sum, the activation, the softmax) and the last
// dot 2*128. At the data-sheet rates (989 TFLOP/s bf16 tensor, 67 TFLOP/s
// f32) the tensor-core work takes 3x the f32 work, and the bytes (per-user
// and per-item rows read once) are far below either, so the kernel is
// bound by tensor-core operations.
//
// Design: the block shape and the chains are K1's (pairwise_mlp.cu): 16
// warps over 8 users x 16 items = 128 pair rows, or 4, 2 or 1 users where
// wider chains need it. Blocks of 128 and 64 rows run the wgmma chain of
// mlp_chain_wgmma.cuh (the assembly writes its 128-byte-swizzled 64-column
// blocks; weights packed by the host, ops/pairwise_mlp.py:wgmma_weights,
// in 16 KB bulk-copied stages): at the flagship widths 229,440 B of shared
// memory, one 512-column buffer that every layer writes over and six ring
// stages. Blocks of 32 and 16 rows run the mma.sync chain of mlp_chain.cuh;
// so does a 64-row block whose wgmma layout does not fit (make_chain_fit:
// the chain [1024, 512, 256]). The item parts of a 16-item tile are 16 x
// Mi*h1 f32 (160 KB at the flagship) and do not fit beside the activation
// buffer, so they stream from global memory (L2) through registers: each
// thread loads the Mi float4s of one (item, 4-column) slot once and
// combines them with all the tile's users. The f32 user rows (8 x h1) and
// the per-pair gates (128 x GATE_PAD), 20,480 B at 128 rows, live in the
// weight ring until the chain starts. The softmax runs once per pair row
// (pair_gates). The weighted sum is an unfused multiply and add per term
// (__fmul_rn, __fadd_rn), in the plain version's order, so that kernel and
// plain version round the same f32 values to bf16; a fused multiply-add
// would round differently and move some activations to the neighbouring
// bf16 value.
//
// int8 mode (K2q, the template flag Q): the same assembly, each bf16
// activation then quantized with layer 0's (inv_a, off) into an int8 code
// (at the byte sw_byte_offset in blocks of 128 and 64 rows, four codes of
// a store inside one 16-byte chunk), and an int8 chain: the s8 wgmma chain
// of mlp_chain_wgmma_int8.cuh at 128 rows and at 64 where that block fits
// (make_chain_fit_int8: 196,672 B at the flagship, one 64 KB code buffer
// and eight 16 KB stages, the scratch within the ring; the weights packed
// by ops/pairwise_mlp.py:wgmma_weights), the mma.sync chain of
// mlp_chain_int8.cuh below; the same codes and scores either way. Its int8
// products take 0.35 ms at the data-sheet rate for 256 x 8,192 flagship
// pairs, while the f32 work (the assembly as above plus each hidden
// layer's quantize and rescale, about 11,500 operations per pair) takes
// about 0.36 ms: bound by f32 operations. On mma.sync the products took
// about 2.7 ms (329 TOP/s, P3), so the s8 wgmma chain is what lets the
// assembly, not the products, set K2q's pace.

#include "mlp_chain_int8.cuh"
#include "mlp_chain_wgmma.cuh"
#include "mlp_chain_wgmma_int8.cuh"

namespace {

using namespace pairwise;

// The gates of the block's pair rows (row r: user u0 + r / TC, item c0 +
// r % TC) into gates [ROWS, GATE_PAD]: the softmax over the first n_mod
// logits ug[u] + ig[c], zero past them; rows past B or C take zero logits.
template <int TB>
__device__ __forceinline__ void pair_gates(const float* __restrict__ ug,
                                           const float* __restrict__ ig,
                                           float* gates, int B, int C, int u0,
                                           int c0, int n_mod) {
  for (int r = threadIdx.x; r < Tile<TB>::ROWS; r += THREADS) {
    const int u = u0 + r / TC, c = c0 + r % TC;
    float l[GATE_PAD];
    float mx = -3.402823466e+38f;  // -FLT_MAX
#pragma unroll
    for (int m = 0; m < GATE_PAD; ++m) {
      l[m] = 0.f;
      if (m < n_mod) {
        l[m] = (u < B ? ug[(size_t)u * GATE_PAD + m] : 0.f) +
               (c < C ? ig[(size_t)c * GATE_PAD + m] : 0.f);
        mx = fmaxf(mx, l[m]);
      }
    }
    float tot = 0.f;
#pragma unroll
    for (int m = 0; m < GATE_PAD; ++m)
      if (m < n_mod) {
        l[m] = expf(l[m] - mx);
        tot += l[m];
      }
    const float inv = 1.f / tot;
#pragma unroll
    for (int m = 0; m < GATE_PAD; ++m)
      gates[r * GATE_PAD + m] = m < n_mod ? l[m] * inv : 0.f;
  }
}

// WG: the mode's wgmma chain (bf16 or s8, at 128 and 64 rows, by fit),
// else its mma.sync chain.
template <bool Q, int TB, bool WG>
__global__ void __launch_bounds__(THREADS)
gated_pairwise_kernel(const float* __restrict__ uf, const float* __restrict__ ug,
                      const float* __restrict__ itf,
                      const float* __restrict__ ig,
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

  // Scratch in the ring: the tile's f32 user rows, then the gates of its
  // pair rows. Rows past B or C assemble from zeros (uniform gates over
  // zero parts) and are never written out. The wgmma chain's first bulk
  // copies and barriers come after the __syncthreads that ends the
  // assembly, once every read of the scratch is done (run_chain_wgmma).
  float* users = reinterpret_cast<float*>(scratch_of<Q, TB>(smem, ch));  // [TB, h1]
  float* gates = users + TB * h1;                            // [ROWS, GATE_PAD]
  for (int e = tid; e < TB * q; e += THREADS) {
    const int bu = e / q, k = (e - bu * q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + bu < B)
      v = __ldg(reinterpret_cast<const float4*>(uf + (size_t)(u0 + bu) * h1 + k));
    *reinterpret_cast<float4*>(users + bu * h1 + k) = v;
  }
  pair_gates<TB>(ug, ig, gates, B, C, u0, c0, n_mod);
  // int8 mode: layer 0's (inv_a, off), bias[0] and bias[1]
  float inv_a = 0.f, off = 0.f;
  if constexpr (Q) {
    inv_a = bias[0];
    off = bias[1];
  }
  __syncthreads();

  // ---- assembly: buf_a[bu * TC + ci] = bf16(act(sum_m g_m * part_m))
  // (int8 mode: its codes; wgmma chain: at its swizzled offset, the four
  // values of a store inside one 16-byte chunk).
  for (int e = tid; e < TC * q; e += THREADS) {
    const int ci = e / q, k = (e - ci * q) * 4;
    float4 it[GATE_PAD - 1];
#pragma unroll
    for (int m = 0; m < GATE_PAD - 1; ++m) {
      it[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < n_item && c0 + ci < C)
        it[m] = __ldg(reinterpret_cast<const float4*>(
            itf + ((size_t)(c0 + ci) * n_item + m) * h1 + k));
    }
#pragma unroll
    for (int bu = 0; bu < TB; ++bu) {
      const int r = bu * TC + ci;
      const float* g = gates + r * GATE_PAD;
      const float4 u = *reinterpret_cast<const float4*>(users + bu * h1 + k);
      const float g0 = g[0];
      float4 x = make_float4(__fmul_rn(g0, u.x), __fmul_rn(g0, u.y),
                             __fmul_rn(g0, u.z), __fmul_rn(g0, u.w));
#pragma unroll
      for (int m = 0; m < GATE_PAD - 1; ++m)
        if (m < n_item) {
          const float gm = g[m + 1];
          x.x = __fadd_rn(x.x, __fmul_rn(gm, it[m].x));
          x.y = __fadd_rn(x.y, __fmul_rn(gm, it[m].y));
          x.z = __fadd_rn(x.z, __fmul_rn(gm, it[m].z));
          x.w = __fadd_rn(x.w, __fmul_rn(gm, it[m].w));
        }
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
  return ((size_t)(rows / TC) * h1 + (size_t)rows * GATE_PAD) * 4;
}

// The chain of a block of `rows` pair rows in either mode, from the HOST
// width array: the int8 layout (K2q, mma.sync), or the bf16 chain by fit
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
cudaError_t launch(const void* uf, const void* ug, const void* itf,
                   const void* ig, const void* w_sw, const void* w,
                   const void* bias, const void* w_last, const void* b_last,
                   void* out, int B, int C, int n_mod, const WgChain& ch,
                   int act, int fin, int rows, cudaStream_t stream) {
  const size_t smem = block_smem<Q>(ch, rows);
  dim3 grid;
  const cudaError_t err = prepare_launch(gated_pairwise_kernel<Q, TB, WG>,
                                         smem, B, C, rows, &grid);
  if (err != cudaSuccess) return err;
  gated_pairwise_kernel<Q, TB, WG><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(uf), static_cast<const float*>(ug),
      static_cast<const float*>(itf), static_cast<const float*>(ig),
      static_cast<const Weight<Q>*>(w_sw),
      static_cast<const Weight<Q>*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(w_last), static_cast<const float*>(b_last),
      static_cast<float*>(out), B, C, n_mod, ch, act, fin);
  return cudaGetLastError();
}

template <bool Q>
int forward(const void* uf, const void* ug, const void* itf, const void* ig,
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
        uf, ug, itf, ig, w_sw, w, bias, w_last, b_last, out, B, C, n_mod, ch,
        act, fin, rows, s);
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from user_first [B, h1], user_gates
// [B, GATE_PAD], item_first [C, Mi*h1] (modality-major within a row) and
// item_gates [C, GATE_PAD], all f32, row-major, 16-byte aligned rows; only
// the first n_mod gate columns are read (2 <= n_mod <= GATE_PAD). The chain
// arguments (w_sw, w, bias, w_last, b_last, n_hidden, widths, act, fin)
// are pairwise_mlp_forward's: w_sw the hidden weights packed for the wgmma
// chain, read in the blocks that run it. Returns cudaSuccess or the first
// CUDA error (launch included); rows is the block's pair rows (128, 64, 32
// or 16: ops/pairwise_mlp.py:block_rows), and a block that does not fit in
// shared memory returns cudaErrorInvalidValue.
int gated_pairwise_mlp_forward(const void* uf, const void* ug, const void* itf,
                               const void* ig, const void* w_sw,
                               const void* w, const void* bias,
                               const void* w_last, const void* b_last,
                               void* out, int B, int C, int n_hidden,
                               const void* widths, int act, int fin,
                               int n_mod, int rows, void* stream) {
  return forward<false>(uf, ug, itf, ig, w_sw, w, bias, w_last, b_last, out,
                        B, C, n_hidden, widths, act, fin, n_mod, rows,
                        stream);
}

// The int8 mode (K2q): the arguments of gated_pairwise_mlp_forward, with the
// chain arguments of pairwise_mlp_int8_forward and w_sw the quantized
// weights packed for the s8 wgmma chain (ops/pairwise_mlp.py:wgmma_weights
// of the int8 chain), read in the blocks that run it: 128 rows, and 64
// where that block fits (make_chain_fit_int8); the int8 mma.sync chain
// below.
int gated_pairwise_mlp_int8_forward(const void* uf, const void* ug,
                                    const void* itf, const void* ig,
                                    const void* w_sw, const void* w,
                                    const void* bias, const void* w_last,
                                    const void* b_last, void* out, int B, int C,
                                    int n_hidden, const void* widths, int act,
                                    int fin, int n_mod, int rows, void* stream) {
  return forward<true>(uf, ug, itf, ig, w_sw, w, bias, w_last, b_last, out,
                       B, C, n_hidden, widths, act, fin, n_mod, rows, stream);
}

// Shared memory a block of `rows` pair rows takes in either mode (int8 != 0:
// K2q), as the launch set-up counts it (on the chain make_chain_fit or
// make_chain_fit_int8 chooses); a negative CUDA error for widths or rows
// the kernel does not take.
int gated_pairwise_mlp_block_bytes(int n_hidden, const void* widths, int int8,
                                   int rows) {
  WgChain ch;
  const cudaError_t err = int8 ? block_chain<true>(n_hidden, widths, rows, &ch)
                               : block_chain<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  return (int)(int8 ? block_smem<true>(ch, rows) : block_smem<false>(ch, rows));
}

// The chain a block of `rows` pair rows of the bf16 mode runs where its
// wgmma block fits: 2 wgmma (128, 64), 1 mma.sync (32, 16).
int gated_pairwise_mlp_chain_kind(int rows) { return chain_kind(rows); }

// The chain a block of `rows` pair rows runs on these widths, in either
// mode (int8 != 0: K2q), as chosen by fit (make_chain_fit,
// make_chain_fit_int8): 2 a wgmma chain (bf16, or s8 in the int8 mode), 1
// mma.sync; a negative CUDA error for widths or rows the kernel does not
// take.
int gated_pairwise_mlp_block_chain_kind(int n_hidden, const void* widths,
                                        int int8, int rows) {
  WgChain ch;
  const cudaError_t err = int8 ? block_chain<true>(n_hidden, widths, rows, &ch)
                               : block_chain<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  return ch.stages ? 2 : 1;
}

}  // extern "C"

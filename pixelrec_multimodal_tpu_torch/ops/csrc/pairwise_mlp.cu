// pixelrec_multimodal_tpu_torch/ops/csrc/pairwise_mlp.cu
//
// Fused concat-fusion pair scoring for Hopper (sm_90a): one launch scores a
// [B users] x [C items] block through the factorized, BatchNorm-folded
// prediction MLP and writes the [B, C] f32 score matrix.
//
// Replaces: pixelrec_multimodal_tpu/ops/pairwise_mlp.py:_pairwise_kernel
// (bf16 mode, reached through pallas_pairwise_scores), and, as
// pairwise_mlp_int8_forward, the same kernel's int8 mode (n_quant > 0: K1q).
//
// What it computes, per (user b, item c) pair:
//   x  = act(bf16(bf16(user_first[b]) + bf16(item_first[c])))   (b1 already
//        folded into item_first: no bias add here)
//   for each hidden Dense (W [K, N] bf16, b [N]):
//        x = bf16(act(bf16(x @ W + bf16(b))))   bf16 operands, f32 accumulate
//   s  = sum_k f32(x[k]) * bf16(w_last[k, 0]) + b_last[0]   (f32, b_last
//        unrounded), then final activation (sigmoid / tanh / none).
// These are the Pallas kernel's rounding points; the module's
// pairwise_scores_plain(compute_dtype=bfloat16) repeats them on tensors.
//
// Bound: at the flagship head (h1 512 -> 256 -> 128 -> 1) a pair costs
// 2*512*256 + 2*256*128 + 2*128 + 3*512 = 329,472 FLOPs and moves almost no
// bytes (the inputs are per-user and per-item rows, read once per tile), so
// the kernel is bound by tensor-core operations, not by memory.
//
// Design against that bound: every activation stays on chip. A block of 16
// warps owns a tile of 8 users x 16 items (128 pair rows), or of 4, 2 or 1
// users where wider chains need it (mlp_chain.cuh). It assembles the
// first-layer activations into shared memory as bf16 with packed bf16x2
// arithmetic, then runs the hidden chain and the last layer. Blocks of 128
// and 64 rows run the wgmma chain of mlp_chain_wgmma.cuh (the assembly
// writes its 128-byte-swizzled 64-column blocks; weights packed by the
// host, ops/pairwise_mlp.py:wgmma_weights, in 16 KB bulk-copied stages):
// at the flagship widths 229,440 B of shared memory, one 512-column buffer
// that every layer writes over (each fits one 256-column sweep) and six
// ring stages. Blocks of 32 and 16 rows run the mma.sync chain of
// mlp_chain.cuh; so does a 64-row block
// whose wgmma layout does not fit (make_chain_fit: the chain [1024, 512,
// 256], whose 1,024-column buffer A leaves no room for two k slices'
// stages). Persistent blocks and a producer warp are left for later work.
//
// int8 mode (K1q, the template flag Q): the same bf16 assembly, each
// activation then quantized with layer 0's (inv_a, off) into an int8 code
// instead of stored as bf16, and an int8 chain: the s8 wgmma chain of
// mlp_chain_wgmma_int8.cuh in blocks of 128 rows and of 64 where that block
// fits (make_chain_fit_int8; the codes at the byte sw_byte_offset, four
// codes of a store inside one 16-byte chunk; the quantized weights packed
// by ops/pairwise_mlp.py:wgmma_weights), the mma.sync chain of
// mlp_chain_int8.cuh below. At the flagship a 128-row block takes 196,672
// B: one 64 KB code buffer that every layer writes over and eight 16 KB
// stages, the bf16 user rows within the ring; the wide chain [1024, 512,
// 256] needs 262,208 B at 128 rows and takes 64 rows on the s8 chain
// (196,672 B), as K2q does. Both blocks give the 128-row mma.sync block's
// scores bit for bit (the integer sums are exact, the last dot keeps its
// float32 order). Its bound: 327,680 int8 tensor-core operations per pair
// at the flagship head (0.347 ms for a 256 x 8,192 block at 1,979 TOP/s),
// with the quantize and rescale of every hidden layer's input and output
// on the f32 units beside it; on mma.sync s8 (329 TOP/s, P3) the products
// alone took about 2 ms of that block.

#include "mlp_chain_int8.cuh"
#include "mlp_chain_wgmma.cuh"
#include "mlp_chain_wgmma_int8.cuh"

namespace {

using namespace pairwise;

// WG: the mode's wgmma chain (bf16 or s8, at 128 and 64 rows, by fit),
// else its mma.sync chain.
template <bool Q, int TB, bool WG>
__global__ void __launch_bounds__(THREADS)
pairwise_mlp_kernel(const float* __restrict__ uf, const float* __restrict__ itf,
                    const Weight<Q>* __restrict__ w_sw,
                    const Weight<Q>* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ w_last,
                    const float* __restrict__ b_last, float* __restrict__ out,
                    int B, int C, WgChain ch, int act, int fin) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);

  const int c0 = blockIdx.x * TC, u0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const int h1 = ch.width[0];
  const int q = h1 / 4;

  // ---- assembly: buf_a[bu * TC + ci] = act(bf16(u) + bf16(i)), as bf16
  // (int8 mode: its codes; wgmma chain: at its swizzled offset, the four
  // values of a store inside one 16-byte chunk). The TB user rows are
  // rounded to bf16 once, into the ring; each item float4 is read once from
  // global memory and paired with all TB users. Rows past B or C assemble
  // from zeros and are never written out. The ring's first bulk copies and
  // barriers come after the __syncthreads below, once every read of the
  // user rows is done (run_chain_wgmma).
  __nv_bfloat16* users =
      reinterpret_cast<__nv_bfloat16*>(scratch_of<Q, TB>(smem, ch));  // [TB, h1]
  for (int e = tid; e < TB * q; e += THREADS) {
    const int bu = e / q, k = (e - bu * q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u0 + bu < B)
      v = __ldg(reinterpret_cast<const float4*>(uf + (size_t)(u0 + bu) * h1 + k));
    *reinterpret_cast<uint2*>(users + bu * h1 + k) = to_bf16x4(v);
  }
  // int8 mode: layer 0's (inv_a, off), bias[0] and bias[1]
  float inv_a = 0.f, off = 0.f;
  if constexpr (Q) {
    inv_a = bias[0];
    off = bias[1];
  }
  __syncthreads();
  for (int e = tid; e < TC * q; e += THREADS) {
    const int ci = e / q, k = (e - ci * q) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 + ci < C)
      v = __ldg(reinterpret_cast<const float4*>(itf + (size_t)(c0 + ci) * h1 + k));
    const uint2 it = to_bf16x4(v);
#pragma unroll
    for (int bu = 0; bu < TB; ++bu) {
      const uint2 u = *reinterpret_cast<const uint2*>(users + bu * h1 + k);
      // bf16 adds, rounded to nearest even: the Pallas kernel's bf16 add.
      const __nv_bfloat162 lo = __hadd2(as_bf162(u.x), as_bf162(it.x));
      const __nv_bfloat162 hi = __hadd2(as_bf162(u.y), as_bf162(it.y));
      const uint2 x =
          make_uint2(as_u32(act_pair(lo, act)), as_u32(act_pair(hi, act)));
      if constexpr (Q && WG) {
        *reinterpret_cast<uint32_t*>(
            smem + sw_byte_offset<Tile<TB>::ROWS>(bu * TC + ci, k)) =
            quantize_bf16x4(x, inv_a, off);
      } else if constexpr (Q) {
        *reinterpret_cast<uint32_t*>(smem + (bu * TC + ci) * ch.stride_a + k) =
            quantize_bf16x4(x, inv_a, off);
      } else if constexpr (WG) {
        *reinterpret_cast<uint2*>(
            buf_a + sw_offset<Tile<TB>::ROWS>(bu * TC + ci, k)) = x;
      } else {
        *reinterpret_cast<uint2*>(buf_a + (bu * TC + ci) * ch.stride_a + k) = x;
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

// The bf16 user rows are the assembly's scratch in the ring.
inline size_t scratch_bytes(int h1, int rows) {
  return (size_t)(rows / TC) * h1 * 2;
}

// The chain of a block of `rows` pair rows in either mode, from the HOST
// width array, by fit: the bf16 chain (make_chain_fit) or the int8 one
// (make_chain_fit_int8), a wgmma chain at 128 and 64 rows where its block
// fits; and the block's shared memory.
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
cudaError_t launch(const void* uf, const void* itf, const void* w_sw,
                   const void* w, const void* bias, const void* w_last,
                   const void* b_last, void* out, int B, int C,
                   const WgChain& ch, int act, int fin, int rows,
                   cudaStream_t stream) {
  const size_t smem = block_smem<Q>(ch, rows);
  dim3 grid;
  const cudaError_t err = prepare_launch(pairwise_mlp_kernel<Q, TB, WG>, smem,
                                         B, C, rows, &grid);
  if (err != cudaSuccess) return err;
  pairwise_mlp_kernel<Q, TB, WG><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(uf), static_cast<const float*>(itf),
      static_cast<const Weight<Q>*>(w_sw),
      static_cast<const Weight<Q>*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(w_last), static_cast<const float*>(b_last),
      static_cast<float*>(out), B, C, ch, act, fin);
  return cudaGetLastError();
}

template <bool Q>
int forward(const void* uf, const void* itf, const void* w_sw, const void* w,
            const void* bias, const void* w_last, const void* b_last,
            void* out, int B, int C, int n_hidden, const void* widths,
            int act, int fin, int rows, void* stream) {
  WgChain ch;
  const cudaError_t err = block_chain<Q>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_chain(rows, ch, [&](auto tb, auto wg) {
    return launch<Q, decltype(tb)::value, decltype(wg)::value>(
        uf, itf, w_sw, w, bias, w_last, b_last, out, B, C, ch, act, fin, rows,
        s);
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from user_first [B, h1] and item_first
// [C, h1] (f32, row-major, 16-byte aligned rows). w_sw holds the hidden
// weights packed for the wgmma chain (mlp_chain_wgmma.cuh; read in the
// blocks that run it), w the hidden layers' [K, N] bf16 weights back to
// back (read by the mma.sync chain), bias their biases (f32 holding
// bf16-rounded values), w_last the bf16-rounded live column of the last
// layer [width[n_hidden]] (f32), b_last its bias (element 0 is read).
// widths is a HOST array of n_hidden + 1 ints, each a positive multiple of
// 16; rows the block's pair rows (128, 64, 32 or 16:
// ops/pairwise_mlp.py:block_rows). Returns cudaSuccess or the first CUDA
// error (launch included); a block that does not fit in shared memory
// returns cudaErrorInvalidValue.
int pairwise_mlp_forward(const void* uf, const void* itf, const void* w_sw,
                         const void* w, const void* bias, const void* w_last,
                         const void* b_last, void* out, int B, int C,
                         int n_hidden, const void* widths, int act, int fin,
                         int rows, void* stream) {
  return forward<false>(uf, itf, w_sw, w, bias, w_last, b_last, out, B, C,
                        n_hidden, widths, act, fin, rows, stream);
}

// The int8 mode (K1q): the arguments of pairwise_mlp_forward, with w_sw
// the quantized weights packed for the s8 wgmma chain
// (ops/pairwise_mlp.py:wgmma_weights of the int8 chain; read in the blocks
// that run it: 128 rows, and 64 where that block fits), w the hidden
// layers' transposed int8 weights [N, K] back to back (read by the int8
// mma.sync chain below), bias the quantization parameters
// (mlp_chain_int8.cuh), w_last the unrounded live column; widths are
// multiples of 32, 1 <= n_hidden <= MAX_HIDDEN.
int pairwise_mlp_int8_forward(const void* uf, const void* itf,
                              const void* w_sw, const void* w,
                              const void* bias, const void* w_last,
                              const void* b_last, void* out, int B, int C,
                              int n_hidden, const void* widths, int act,
                              int fin, int rows, void* stream) {
  return forward<true>(uf, itf, w_sw, w, bias, w_last, b_last, out, B, C,
                       n_hidden, widths, act, fin, rows, stream);
}

// Shared memory a block of `rows` pair rows takes in either mode (int8 != 0:
// K1q), as the launch set-up counts it (on the chain make_chain_fit or
// make_chain_fit_int8 chooses); a negative CUDA error for widths or rows
// the kernel does not take.
int pairwise_mlp_block_bytes(int n_hidden, const void* widths, int int8,
                             int rows) {
  WgChain ch;
  const cudaError_t err = int8 ? block_chain<true>(n_hidden, widths, rows, &ch)
                               : block_chain<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  return (int)(int8 ? block_smem<true>(ch, rows) : block_smem<false>(ch, rows));
}

// The chain a block of `rows` pair rows of the bf16 mode runs where its
// wgmma block fits: 2 wgmma (128, 64), 1 mma.sync (32, 16).
int pairwise_mlp_chain_kind(int rows) { return chain_kind(rows); }

// The chain a block of `rows` pair rows runs on these widths, in either
// mode (int8 != 0: K1q), as chosen by fit (make_chain_fit,
// make_chain_fit_int8): 2 a wgmma chain (bf16, or s8 in the int8 mode), 1
// mma.sync; a negative CUDA error for widths or rows the kernel does not
// take.
int pairwise_mlp_block_chain_kind(int n_hidden, const void* widths, int int8,
                                  int rows) {
  WgChain ch;
  const cudaError_t err = int8 ? block_chain<true>(n_hidden, widths, rows, &ch)
                               : block_chain<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  return ch.stages ? 2 : 1;
}

}  // extern "C"

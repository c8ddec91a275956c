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
// warps owns a tile of 8 users x 16 items (128 pair rows; at the flagship
// widths the block's ~222 KB of shared memory fill one SM), or of 4, 2 or 1
// users where wider chains need it (mlp_chain.cuh). It assembles
// the first-layer activations into shared memory as bf16 with packed
// bf16x2 arithmetic, then runs the hidden chain and the last layer of
// mlp_chain.cuh (mma.sync on the tensor cores, weights through a cp.async
// ring), which the gated kernels share.
// wgmma, TMA and persistent blocks are left for later work.
//
// int8 mode (K1q, the template flag Q): the same bf16 assembly, each
// activation then quantized with layer 0's (inv_a, off) into an int8 code
// instead of stored as bf16, and the int8 chain of mlp_chain_int8.cuh. Its
// bound: 327,680 int8 tensor-core operations per pair at the flagship head,
// half the bf16 time at the data-sheet rates (1,979 TOP/s int8), with the
// quantize and rescale of every hidden layer's input and output on the f32
// units beside it.

#include "mlp_chain_int8.cuh"

namespace {

using namespace pairwise;

template <bool Q, int TB>
__global__ void __launch_bounds__(THREADS)
pairwise_mlp_kernel(const float* __restrict__ uf, const float* __restrict__ itf,
                    const Weight<Q>* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ w_last,
                    const float* __restrict__ b_last, float* __restrict__ out,
                    int B, int C, Chain ch, int act, int fin) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);

  const int c0 = blockIdx.x * TC, u0 = blockIdx.y * TB;
  const int tid = threadIdx.x;
  const int h1 = ch.width[0];
  const int q = h1 / 4;

  // ---- assembly: buf_a[bu * TC + ci] = act(bf16(u) + bf16(i)), as bf16
  // (int8 mode: its codes). The TB user rows are rounded to bf16 once, into
  // the ring; each item float4 is read once from global memory and paired
  // with all TB users. Rows past B or C assemble from zeros and are never
  // written out.
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
      if constexpr (Q) {
        *reinterpret_cast<uint32_t*>(smem + (bu * TC + ci) * ch.stride_a + k) =
            quantize_bf16x4(x, inv_a, off);
      } else {
        *reinterpret_cast<uint2*>(buf_a + (bu * TC + ci) * ch.stride_a + k) = x;
      }
    }
  }
  __syncthreads();
  if constexpr (Q) {
    run_chain_int8<TB>(smem, w, bias, w_last, b_last, out, B, C, u0, c0, ch,
                       act, fin);
  } else {
    run_chain<TB>(buf_a, w, bias, w_last, b_last, out, B, C, u0, c0, ch, act,
                  fin);
  }
}

// The bf16 user rows are the assembly's scratch in the ring.
inline size_t scratch_bytes(const Chain& ch, int rows) {
  return (size_t)(rows / TC) * ch.width[0] * 2;
}

template <bool Q>
int forward(const void* uf, const void* itf, const void* w, const void* bias,
            const void* w_last, const void* b_last, void* out, int B, int C,
            int n_hidden, const void* widths, int act, int fin, int rows,
            void* stream) {
  Chain ch;
  cudaError_t err = make_chain_of<Q>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_of<Q>(ch, scratch_bytes(ch, rows), rows);
  return dispatch_rows(rows, [&](auto tb) {
    constexpr int TB = decltype(tb)::value;
    dim3 grid;
    cudaError_t e =
        prepare_launch(pairwise_mlp_kernel<Q, TB>, smem, B, C, rows, &grid);
    if (e != cudaSuccess) return e;
    pairwise_mlp_kernel<Q, TB><<<grid, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(uf), static_cast<const float*>(itf),
        static_cast<const Weight<Q>*>(w), static_cast<const float*>(bias),
        static_cast<const float*>(w_last), static_cast<const float*>(b_last),
        static_cast<float*>(out), B, C, ch, act, fin);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Scores out[B, C] (f32, row-major) from user_first [B, h1] and item_first
// [C, h1] (f32, row-major, 16-byte aligned rows). w holds the hidden layers'
// [K, N] bf16 weights back to back, bias their biases (f32 holding
// bf16-rounded values), w_last the bf16-rounded live column of the last
// layer [width[n_hidden]] (f32), b_last its bias (element 0 is read).
// widths is a HOST array of n_hidden + 1 ints, each a positive multiple of
// 16; rows the block's pair rows (128, 64, 32 or 16:
// ops/pairwise_mlp.py:block_rows). Returns cudaSuccess or the first CUDA
// error (launch included); a block that does not fit in shared memory
// returns cudaErrorInvalidValue.
int pairwise_mlp_forward(const void* uf, const void* itf, const void* w,
                         const void* bias, const void* w_last,
                         const void* b_last, void* out, int B, int C,
                         int n_hidden, const void* widths, int act, int fin,
                         int rows, void* stream) {
  return forward<false>(uf, itf, w, bias, w_last, b_last, out, B, C, n_hidden,
                        widths, act, fin, rows, stream);
}

// The int8 mode (K1q): the arguments of pairwise_mlp_forward, with w the
// hidden layers' transposed int8 weights [N, K] back to back, bias the
// quantization parameters (mlp_chain_int8.cuh), w_last the unrounded live
// column; widths are multiples of 32, 1 <= n_hidden <= MAX_HIDDEN.
int pairwise_mlp_int8_forward(const void* uf, const void* itf, const void* w,
                              const void* bias, const void* w_last,
                              const void* b_last, void* out, int B, int C,
                              int n_hidden, const void* widths, int act,
                              int fin, int rows, void* stream) {
  return forward<true>(uf, itf, w, bias, w_last, b_last, out, B, C, n_hidden,
                       widths, act, fin, rows, stream);
}

// Shared memory a block of `rows` pair rows takes in either mode (int8 != 0:
// K1q), as the launch set-up counts it; a negative CUDA error for widths
// the kernel does not take.
int pairwise_mlp_block_bytes(int n_hidden, const void* widths, int int8,
                             int rows) {
  Chain ch;
  const cudaError_t err = int8 ? make_chain_of<true>(n_hidden, widths, rows, &ch)
                               : make_chain_of<false>(n_hidden, widths, rows, &ch);
  if (err != cudaSuccess) return -(int)err;
  const size_t scratch = scratch_bytes(ch, rows);
  return (int)(int8 ? smem_of<true>(ch, scratch, rows)
                    : smem_of<false>(ch, scratch, rows));
}

}  // extern "C"

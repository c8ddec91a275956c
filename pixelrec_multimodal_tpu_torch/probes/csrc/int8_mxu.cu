// pixelrec_multimodal_tpu_torch/probes/csrc/int8_mxu.cu
//
// Hopper probe P3: the rate of the pair kernels' own product loop, in bf16
// and in int8, without their assembly (probes/int8_mxu.py times it).
//
// Replaces: scripts/profile_int8_mxu.py:run_variant, the Pallas probe of the
// TPU's matrix unit (bf16_chain_kernel, and int8_chain_kernel with rescale
// False and True).
//
// What it computes, per row of x [R, 512] (rows are independent), K steps
// of the pair kernels' tile shape, summed into acc [R, 128] f32:
//   bf16:   h = bf16(relu(x @ w1)), z = h @ w2 (f32 sums), acc += z,
//           x[:, :128] = bf16(z)
//   int8 raw:     h32 = x @ w1 (int32), h = int8(h32 >> 8) (wrapping),
//                 z32 = h @ w2, acc += f32(z32) / 4096, x[:, :128] =
//                 int8(z32 >> 6)
//   int8 rescale: h = int8(clip(relu(f32(h32) / 16384) * 4, -127, 127))
//                 (truncated toward zero), otherwise as raw
// with w1 [512, 256] and w2 [256, 128]. The integer sums are exact (|h32| <
// 512 * 127^2 < 2^24) and every float32 step rounds once, as the plain
// version's, so the int8 modes equal it bit for bit.
//
// Design: the product loops are mlp_chain.cuh's (mma.sync m16n8k16 bf16 fed
// by ldmatrix, the three-slice cp.async weight ring: chain_pass) and
// mlp_chain_int8.cuh's (m16n8k32 s8, weights kept [N, K]: chain_pass_int8),
// on a block of 128 rows and 16 warps, x and h in shared memory as the pair
// kernels hold their activation buffers (226,816 B in bf16, 133,120 B in
// int8). Blocks own row tiles; the grid's second dimension repeats the whole
// pass `instances` times (the Pallas probe's grid over one block), every
// block storing its result so that no pass can be dropped.
//
// Bound: tensor-core operations, 2 * R * (512 * 256 + 256 * 128) * K per
// instance; w1 and w2 (262,144 + 65,536 B in bf16) stream from L2 through
// the ring, once per 128-column pass.

#include "mlp_chain_int8.cuh"

namespace {

using namespace pairwise;

constexpr int H1 = 512, H2 = 256, H3 = 128;
constexpr int PTB = 8;  // 128 rows per block
using PT = Tile<PTB>;
constexpr int XS = H1 + PAD, HS = H2 + PAD;      // bf16 row strides
constexpr int XSQ = H1 + QPAD, HSQ = H2 + QPAD;  // int8 row strides (bytes)

constexpr size_t smem_bf16() {
  return (size_t)PT::ROWS * (XS + HS) * 2 + (size_t)STAGES * KS * WSTRIDE * 2;
}
constexpr size_t smem_int8() {
  return (size_t)PT::ROWS * (XSQ + HSQ) + (size_t)STAGES * NB * QWSTRIDE;
}

// MODE 0: bf16; 1: int8 raw; 2: int8 rescale.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
chain_probe_kernel(const void* __restrict__ x, const void* __restrict__ w1,
                   const void* __restrict__ w2, float* __restrict__ out,
                   int R, int K) {
  constexpr bool Q = MODE > 0;
  using E = std::conditional_t<Q, int8_t, __nv_bfloat16>;
  constexpr int xs = Q ? XSQ : XS, hs = Q ? HSQ : HS;
  extern __shared__ __align__(128) unsigned char smem[];
  E* xa = reinterpret_cast<E*>(smem);
  E* hb = xa + PT::ROWS * xs;
  E* wbuf = hb + PT::ROWS * hs;
  const int r0 = blockIdx.x * PT::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % PT::RG, wc = warp / PT::RG;
  const int g = lane >> 2, t = lane & 3;

  // x's row tile (rows past R: zeros), 16 bytes at a time
  constexpr int VEC = H1 * (int)sizeof(E) / 16;
  for (int e = threadIdx.x; e < PT::ROWS * VEC; e += THREADS) {
    const int r = e / VEC, v = e - r * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < R)
      val = __ldg(reinterpret_cast<const uint4*>(
                      static_cast<const E*>(x) + (size_t)(r0 + r) * H1) + v);
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(xa + r * xs) +
                              v * 16) = val;
  }
  __syncthreads();

  float total[PT::NT][4];
#pragma unroll
  for (int j = 0; j < PT::NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) total[j][r] = 0.f;

  for (int step = 0; step < K; ++step) {
    // h = x @ w1, two 128-column passes, into hb
    for (int n0 = 0; n0 < H2; n0 += NB) {
      std::conditional_t<Q, int, float> acc[PT::NT][4];
#pragma unroll
      for (int j = 0; j < PT::NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0;
      if constexpr (Q)
        chain_pass_int8<PTB>(xa, xs, static_cast<const int8_t*>(w1), H1, H2,
                             n0, wbuf, acc);
      else
        chain_pass<PTB>(xa, xs, static_cast<const __nv_bfloat16*>(w1), H1,
                        H2, n0, wbuf, acc);
#pragma unroll
      for (int j = 0; j < PT::NT; ++j) {
        const int col = n0 + wc * PT::WN + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wr * 16 + g + 8 * h;
          if constexpr (MODE == 0) {
            *reinterpret_cast<__nv_bfloat162*>(hb + row * hs + col) =
                __floats2bfloat162_rn(fmaxf(acc[j][2 * h], 0.f),
                                      fmaxf(acc[j][2 * h + 1], 0.f));
          } else {
            int8_t q[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int a = acc[j][2 * h + i];
              if constexpr (MODE == 1) {
                q[i] = static_cast<int8_t>(a >> 8);
              } else {
                const float hf = fmaxf(
                    __fmul_rn(__int2float_rn(a), 1.f / 16384.f), 0.f);
                q[i] = static_cast<int8_t>(__float2int_rz(
                    fminf(fmaxf(__fmul_rn(hf, 4.f), -127.f), 127.f)));
              }
            }
            *reinterpret_cast<uint16_t*>(hb + row * hs + col) =
                (uint16_t)((uint8_t)q[0] | ((uint16_t)(uint8_t)q[1] << 8));
          }
        }
      }
      __syncthreads();
    }
    // z = h @ w2, one pass; acc += z; x[:, :128] = z, rounded or shifted
    std::conditional_t<Q, int, float> z[PT::NT][4];
#pragma unroll
    for (int j = 0; j < PT::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) z[j][r] = 0;
    if constexpr (Q)
      chain_pass_int8<PTB>(hb, hs, static_cast<const int8_t*>(w2), H2, H3, 0,
                           wbuf, z);
    else
      chain_pass<PTB>(hb, hs, static_cast<const __nv_bfloat16*>(w2), H2, H3,
                      0, wbuf, z);
#pragma unroll
    for (int j = 0; j < PT::NT; ++j) {
      const int col = wc * PT::WN + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wr * 16 + g + 8 * h;
        if constexpr (MODE == 0) {
          total[j][2 * h] = __fadd_rn(total[j][2 * h], z[j][2 * h]);
          total[j][2 * h + 1] = __fadd_rn(total[j][2 * h + 1], z[j][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(xa + row * xs + col) =
              __floats2bfloat162_rn(z[j][2 * h], z[j][2 * h + 1]);
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            total[j][2 * h + i] = __fadd_rn(
                total[j][2 * h + i],
                __fmul_rn(__int2float_rn(z[j][2 * h + i]), 1.f / 4096.f));
          *reinterpret_cast<uint16_t*>(xa + row * xs + col) =
              (uint16_t)((uint8_t)static_cast<int8_t>(z[j][2 * h] >> 6) |
                         ((uint16_t)(uint8_t)static_cast<int8_t>(
                              z[j][2 * h + 1] >> 6)
                          << 8));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PT::NT; ++j) {
    const int col = wc * PT::WN + j * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wr * 16 + g + 8 * h;
      if (row < R)
        *reinterpret_cast<float2*>(out + (size_t)row * H3 + col) =
            make_float2(total[j][2 * h], total[j][2 * h + 1]);
    }
  }
}

template <int MODE>
cudaError_t launch(const void* x, const void* w1, const void* w2, void* out,
                   int R, int K, int instances, cudaStream_t stream) {
  const size_t smem = MODE ? smem_int8() : smem_bf16();
  cudaError_t err = cudaFuncSetAttribute(
      chain_probe_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + PT::ROWS - 1) / PT::ROWS, instances);
  chain_probe_kernel<MODE><<<grid, THREADS, smem, stream>>>(
      x, w1, w2, static_cast<float*>(out), R, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// P3: out [R, 128] (f32) from x [R, 512], w1 and w2, in mode 0 (bf16: x
// bf16, w1 [512, 256], w2 [256, 128] bf16, row-major), 1 (int8 raw) or 2
// (int8 rescale: x int8, w1 and w2 int8 transposed, [256, 512] and
// [128, 256]), K steps, `instances` passes over all the rows. Every pointer
// 16-byte aligned. Returns cudaSuccess or the first CUDA error (launch
// included).
int int8_mxu_forward(const void* x, const void* w1, const void* w2, void* out,
                     int R, int K, int mode, int instances, void* stream) {
  if (R < 1 || K < 1 || instances < 1 || instances > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(x, w1, w2, out, R, K, instances, s);
    case 1: return launch<1>(x, w1, w2, out, R, K, instances, s);
    case 2: return launch<2>(x, w1, w2, out, R, K, instances, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"

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
// Design: the product loop of the pair kernels' wgmma chains, step for
// step: wgmma.mma_async m64n128k16 bf16 (mlp_chain_wgmma.cuh) or m64n128k32
// s8 (mlp_chain_wgmma_int8.cuh) from 128-byte-swizzled shared-memory
// descriptors, four warpgroups over a group of 128-column tiles, one k
// slice's products in flight while the block releases the stages of the
// slice before, the weights (packed by the host as
// ops/pairwise_mlp.py:wgmma_weights packs a chain) through the ring of 16
// KB stages that thread 0 fills by bulk copies on mbarriers
// (WeightStream, its cursor wrapping round the two layers K times). x and h
// live in shared memory in the chains' swizzled layout (sw_offset,
// sw_byte_offset); layer 0 writes h beside x (x's last 384 columns outlive
// the step), layer 1 folds z into x's first 128 columns. As in the chains,
// no branch encloses a product: a warpgroup past a layer's last column
// tile multiplies that tile too and writes nothing (layer 0 has two tiles,
// layer 1 one).
//
// The accumulator: acc lives in shared memory, 64 floats for each thread
// of the warpgroups that own z (column tile 0), strided by their count so
// that a warp's accesses fall in distinct banks. In registers it would sit
// beside the 64 of the product's fragment all through the loop and take
// those threads past the 128 registers a 512-thread block allows (spills);
// the pair kernels' last dot keeps no such state either.
//
// The block by fit: 128 rows where x, h, acc and at least two k slices'
// stages (4) fit 232,448 B, else 64. bf16 at 128 rows needs 262,144 B
// before the ring, so it takes 64 rows (131,072 B and six stages, 229,440
// B); int8 takes 128 rows (163,840 B and four stages, 229,440 B), and 64
// rows (81,920 B, eight stages) where the caller forces them. Blocks own
// row tiles; the grid's second dimension repeats the whole pass
// `instances` times (the Pallas probe's grid over one block), every block
// storing its result so that no pass can be dropped.
//
// Bound: tensor-core operations, 2 * R * (512 * 256 + 256 * 128) * K per
// instance; w1 and w2 (327,680 B in bf16, half in int8) stream from L2
// through the ring, once per step.

#include <type_traits>

#include "mlp_chain_wgmma_int8.cuh"

namespace {

using namespace pairwise;

constexpr int H1 = 512, H2 = 256, H3 = 128;
constexpr int ACC_ROW_BYTES = H3 * 4;  // acc, f32
constexpr int LEAST_STAGES = 4;  // two k slices of layer 0's two tiles

// Byte offset of (row r, column k) in a swizzled buffer of ROWS rows: the
// chains' layout, bf16 (Q false) or int8 codes.
template <bool Q, int ROWS>
__device__ __forceinline__ int at(int r, int k) {
  if constexpr (Q)
    return sw_byte_offset<ROWS>(r, k);
  else
    return 2 * sw_offset<ROWS>(r, k);
}

// Thread 0's cursor over the weight stages: the chain's WeightStream over
// both layers, begun again until `left` more passes are issued.
template <int TB, typename E>
struct Passes {
  WeightStream<TB, E> s;
  int left;
  __device__ __forceinline__ bool more(const Chain& ch) const {
    return s.more(ch);
  }
  __device__ __forceinline__ void issue(const Chain& ch, void* dst,
                                        uint64_t* bar) {
    s.issue(ch, dst, bar);
    if (!s.more(ch) && left > 0) {
      --left;
      s.l = 0;
    }
  }
};

// The block's ring: S stages at wbuf, their barriers, the cursor, and the
// count of stages consumed (stage tile % S, its phase).
template <int TB, typename E>
struct Ring {
  unsigned char* wbuf;
  uint64_t* full;
  int S;
  Passes<TB, E> stream;
  unsigned tile;

  // Thread 0 refills the n stages from tile t on, once every warpgroup is
  // done with them.
  __device__ __forceinline__ void refill(const Chain& ch, unsigned t, int n) {
    if (threadIdx.x == 0)
      for (int i = 0; i < n && stream.more(ch); ++i)
        stream.issue(ch, wbuf + ((t + i) % S) * WG_STAGE_BYTES,
                     &full[(t + i) % S]);
  }
};

// acc = in [ROWS, kd] x the ring's next kd / slice k slices of `tiles`
// column tiles each, the warpgroup's tile nt (the last one past them), as
// run_chain_wgmma and run_chain_wgmma_int8 sweep a group.
template <bool Q, int TB, typename A, typename E>
__device__ __forceinline__ void sweep(A (&acc)[64], const unsigned char* in,
                                      int kd, int tiles, Ring<TB, E>& ring,
                                      const Chain& ch) {
  using T = WgTile<TB>;
  constexpr int ROWS = T::ROWS;
  constexpr int SLICE = Q ? WQ_K : WG_K;  // k of a stage: 128 bytes
  const int wg = threadIdx.x >> 7, mt = wg % T::MT, nt = wg / T::MT;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int k0 = 0; k0 < kd; k0 += SLICE, ring.tile += tiles) {
    const unsigned t = ring.tile + (nt < tiles ? nt : tiles - 1);
    mbar_wait(&ring.full[t % ring.S], (t / ring.S) & 1);
    const unsigned char* a = in + (k0 / SLICE) * ROWS * 128 + mt * 64 * 128;
    const unsigned char* b = ring.wbuf + (t % ring.S) * WG_STAGE_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (Q)
        wgmma_64x128x32_s8(acc, sw128_desc(a + kk * 32),
                           sw128_desc(b + kk * 32));
      else
        wgmma_64x128x16(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();
    __syncthreads();
    if (k0) ring.refill(ch, ring.tile - tiles, tiles);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();
  ring.refill(ch, ring.tile - tiles, tiles);
}

// h of the thread's column pair from fragment entries a0, a1, stored at p:
// bf16(relu), or the int8 mode's code.
template <int MODE>
__device__ __forceinline__ void store_h(unsigned char* p, float a0, float a1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __floats2bfloat162_rn(fmaxf(a0, 0.f), fmaxf(a1, 0.f));
}
template <int MODE>
__device__ __forceinline__ void store_h(unsigned char* p, int a0, int a1) {
  int8_t q[2];
  const int a[2] = {a0, a1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (MODE == 1) {
      q[i] = static_cast<int8_t>(a[i] >> 8);
    } else {
      const float hf =
          fmaxf(__fmul_rn(__int2float_rn(a[i]), 1.f / 16384.f), 0.f);
      q[i] = static_cast<int8_t>(
          __float2int_rz(fminf(fmaxf(__fmul_rn(hf, 4.f), -127.f), 127.f)));
    }
  }
  *reinterpret_cast<uint16_t*>(p) =
      (uint16_t)((uint8_t)q[0] | ((uint16_t)(uint8_t)q[1] << 8));
}

// The fold of z's column pair into x at p, and its f32 value for acc.
__device__ __forceinline__ float2 fold(unsigned char* p, float z0, float z1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(z0, z1);
  return make_float2(z0, z1);
}
__device__ __forceinline__ float2 fold(unsigned char* p, int z0, int z1) {
  *reinterpret_cast<uint16_t*>(p) =
      (uint16_t)((uint8_t)static_cast<int8_t>(z0 >> 6) |
                 ((uint16_t)(uint8_t)static_cast<int8_t>(z1 >> 6) << 8));
  return make_float2(__fmul_rn(__int2float_rn(z0), 1.f / 4096.f),
                     __fmul_rn(__int2float_rn(z1), 1.f / 4096.f));
}

// MODE 0: bf16; 1: int8 raw; 2: int8 rescale. w: w1 then w2, packed; ch
// the chain [H1, H2, H3] the stream reads them by (probe_chain).
template <int MODE, int TB>
__global__ void __launch_bounds__(THREADS)
chain_probe_kernel(const void* __restrict__ x, const void* __restrict__ w,
                   float* __restrict__ out, int R, int K, int S,
                   const Chain ch) {
  constexpr bool Q = MODE > 0;
  using E = std::conditional_t<Q, int8_t, __nv_bfloat16>;
  using A = std::conditional_t<Q, int, float>;
  using T = WgTile<TB>;
  constexpr int ROWS = T::ROWS;
  constexpr int EB = (int)sizeof(E);
  constexpr int OWN = T::MT * 128;  // threads that own z
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* xa = smem;                           // [ROWS, H1]
  unsigned char* hb = xa + ROWS * H1 * EB;            // [ROWS, H2]
  float* total = reinterpret_cast<float*>(hb + ROWS * H2 * EB);  // [64][OWN]
  unsigned char* wbuf =
      reinterpret_cast<unsigned char*>(total) + ROWS * ACC_ROW_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, mt = wg % T::MT, nt = wg / T::MT;
  const int r0 = blockIdx.x * ROWS;
  const int row = mt * 64 + (warp & 3) * 16 + (lane >> 2);  // fragment's
  const int own = mt * 128 + (tid & 127);

  Ring<TB, E> ring{wbuf, reinterpret_cast<uint64_t*>(wbuf + S * WG_STAGE_BYTES),
                   S, {{static_cast<const E*>(w)}, K - 1}, 0u};
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&ring.full[s]);
    mbar_init_fence();
  }
  // x's row tile (rows past R: zeros), 16 bytes at a time, swizzled
  constexpr int VEC = H1 * EB / 16;
  for (int e = tid; e < ROWS * VEC; e += THREADS) {
    const int r = e / VEC, k = (e - r * VEC) * (16 / EB);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < R)
      v = __ldg(reinterpret_cast<const uint4*>(static_cast<const E*>(x) +
                                               (size_t)(r0 + r) * H1 + k));
    *reinterpret_cast<uint4*>(xa + at<Q, ROWS>(r, k)) = v;
  }
  if (nt == 0)
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i * OWN + own] = 0.f;
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < S && ring.stream.more(ch); ++s)
      ring.stream.issue(ch, wbuf + s * WG_STAGE_BYTES, &ring.full[s]);

  A acc[64];
  for (int step = 0; step < K; ++step) {
    // h = x @ w1: two column tiles of 128
    sweep<Q, TB>(acc, xa, H1, 2, ring, ch);
    if (nt < 2) {
      const int col0 = nt * WG_N + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_h<MODE>(hb + at<Q, ROWS>(row + 8 * h, col0 + 8 * j),
                        acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    fence_proxy_async();
    __syncthreads();
    // z = h @ w2: one tile; acc += z; x[:, :128] = z, rounded or shifted
    sweep<Q, TB>(acc, hb, H2, 1, ring, ch);
    if (nt == 0) {
      const int col0 = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const float2 z = fold(xa + at<Q, ROWS>(row + 8 * h, col0 + 8 * j),
                                acc[i], acc[i + 1]);
          total[i * OWN + own] = __fadd_rn(total[i * OWN + own], z.x);
          total[(i + 1) * OWN + own] =
              __fadd_rn(total[(i + 1) * OWN + own], z.y);
        }
    }
    fence_proxy_async();
    __syncthreads();
  }

  if (nt == 0) {
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h, r = r0 + row + 8 * h;
        if (r < R)
          *reinterpret_cast<float2*>(out + (size_t)r * H3 + col0 + 8 * j) =
              make_float2(total[i * OWN + own], total[(i + 1) * OWN + own]);
      }
  }
}

// Ring stages of a block of `rows` (128 or 64) rows in `mode`: as many 16
// KB stages as the shared memory left after x, h and acc holds, up to
// WG_MAX_STAGES; 0 where fewer than LEAST_STAGES fit or for other rows.
inline int probe_stages(int mode, int rows) {
  if (mode < 0 || mode > 2 || !(rows == 128 || rows == 64)) return 0;
  const long long fixed =
      (long long)rows * ((H1 + H2) * (mode ? 1 : 2) + ACC_ROW_BYTES);
  const long long fit =
      (WG_SMEM - WG_BARRIER_BYTES - fixed) / (long long)WG_STAGE_BYTES;
  return fit < LEAST_STAGES    ? 0
         : fit > WG_MAX_STAGES ? WG_MAX_STAGES
                               : (int)fit;
}

// The probe's two layers as a chain: widths [H1, H2, H3], w2 packed after
// w1's H1 x H2 elements (both multiples of a k slice and of 64 columns).
inline Chain probe_chain() {
  Chain ch{};
  ch.n_hidden = 2;
  ch.width[0] = H1;
  ch.width[1] = H2;
  ch.width[2] = H3;
  ch.w_off[1] = (long long)H1 * H2;
  return ch;
}

inline size_t probe_smem(int mode, int rows) {
  return (size_t)rows * ((H1 + H2) * (mode ? 1 : 2) + ACC_ROW_BYTES) +
         (size_t)probe_stages(mode, rows) * WG_STAGE_BYTES + WG_BARRIER_BYTES;
}

template <int MODE, int TB>
cudaError_t launch(const void* x, const void* w, void* out, int R, int K,
                   int instances, cudaStream_t stream) {
  constexpr int ROWS = WgTile<TB>::ROWS;
  const int S = probe_stages(MODE, ROWS);
  const size_t smem = probe_smem(MODE, ROWS);
  cudaError_t err = cudaFuncSetAttribute(
      chain_probe_kernel<MODE, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + ROWS - 1) / ROWS, instances);
  chain_probe_kernel<MODE, TB><<<grid, THREADS, smem, stream>>>(
      x, w, static_cast<float*>(out), R, K, S, probe_chain());
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// P3: out [R, 128] (f32) from x [R, 512] and w_sw, in mode 0 (bf16: x bf16,
// w_sw w1 [512, 256] then w2 [256, 128] bf16, packed as
// ops/pairwise_mlp.py:wgmma_weights packs the chain [512, 256, 128]), 1
// (int8 raw) or 2 (int8 rescale: x int8, w_sw the int8 chain's packing of
// w1^T and w2^T), K steps, `instances` passes over all the rows, in blocks
// of `rows` rows (int8_mxu_block_rows, or 64 where that block fits too).
// Every pointer 16-byte aligned. Returns cudaSuccess or the first CUDA
// error (launch included); cudaErrorInvalidValue for a block that does not
// fit.
int int8_mxu_forward(const void* x, const void* w_sw, void* out, int R, int K,
                     int mode, int instances, int rows, void* stream) {
  if (R < 1 || K < 1 || instances < 1 || instances > 65535 ||
      !probe_stages(mode, rows))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * mode + (rows == 128)) {
    case 0: return launch<0, 4>(x, w_sw, out, R, K, instances, s);
    case 2: return launch<1, 4>(x, w_sw, out, R, K, instances, s);
    case 3: return launch<1, 8>(x, w_sw, out, R, K, instances, s);
    case 4: return launch<2, 4>(x, w_sw, out, R, K, instances, s);
    case 5: return launch<2, 8>(x, w_sw, out, R, K, instances, s);
    default: return cudaErrorInvalidValue;
  }
}

// The block rows of `mode` by fit: 128 where that block fits, else 64; a
// negative CUDA error for another mode.
int int8_mxu_block_rows(int mode) {
  if (mode < 0 || mode > 2) return -(int)cudaErrorInvalidValue;
  return probe_stages(mode, 128) ? 128 : 64;
}

// Shared memory of a block of `rows` rows in `mode`, as the launch counts
// it; a negative CUDA error where that block does not fit.
int int8_mxu_block_bytes(int mode, int rows) {
  if (!probe_stages(mode, rows)) return -(int)cudaErrorInvalidValue;
  return (int)probe_smem(mode, rows);
}

}  // extern "C"

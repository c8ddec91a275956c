// pixelrec_multimodal_tpu_torch/data/csrc/jpeg_decode.cu
//
// JPEG validation and decode on the card through the CUDA toolkit's nvJPEG,
// for the image tier's offline mode where PIL is not installed
// (data/image_codecs.py:NvjpegDecoder). It replaces no TPU kernel: the JAX
// package validates images with PIL on the host
// (pixelrec_multimodal_tpu/data/preprocessing.py:is_image_corrupted,
// check_image_dimensions). Built by ops/_build.py at first use, linked with
// -lnvjpeg; a plain C interface loaded through ctypes.
//
// One nvJPEG handle for the process, made at first use under a mutex; the
// library lets threads share it. A decode needs a decode state of its own
// (nvjpegJpegState_t: the library's buffers for one stream at a time), so
// each concurrent caller holds one, made by jpeg_state_create: the
// callers' Huffman passes, which run on the host inside nvjpegDecode, then
// overlap. jpeg_info reads the header (nvjpegGetImageInfo): components,
// chroma subsampling, width and height of the first component. jpeg_decode
// decodes a whole stream with the caller's state into dst, an RGB
// interleaved H x W x 3 uint8 buffer on the card (NVJPEG_OUTPUT_RGBI), or
// H x W for a grayscale stream (NVJPEG_OUTPUT_Y), on the given stream,
// then waits for that stream: the verdict has to cover the device part of
// the decode, and the next call reuses the state's buffers. Each returns
// the nvjpegStatus_t (0 on success), or minus the CUDA error of the wait.
//
// Bound: one file per call and state, a few launches and one wait each;
// the host's Huffman pass and the launches bound it, not the card's bytes
// or operations.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <mutex>

namespace {

std::mutex mu;
nvjpegHandle_t handle = nullptr;

int ready() {
  std::lock_guard<std::mutex> guard(mu);
  if (handle != nullptr) return 0;
  nvjpegStatus_t s = nvjpegCreateSimple(&handle);
  if (s != NVJPEG_STATUS_SUCCESS) {
    handle = nullptr;
    return static_cast<int>(s);
  }
  return 0;
}

}  // namespace

extern "C" int jpeg_state_create(void** out) {
  int s = ready();
  if (s != 0) return s;
  nvjpegJpegState_t state = nullptr;
  nvjpegStatus_t st = nvjpegJpegStateCreate(handle, &state);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  *out = state;
  return 0;
}

extern "C" int jpeg_state_destroy(void* state) {
  return static_cast<int>(
      nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state)));
}

extern "C" int jpeg_info(const unsigned char* data, long long length,
                         int* out) {
  int s = ready();
  if (s != 0) return s;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  nvjpegStatus_t st = nvjpegGetImageInfo(
      handle, data, static_cast<size_t>(length), &components, &subsampling,
      widths, heights);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  out[0] = components;
  out[1] = static_cast<int>(subsampling);
  out[2] = widths[0];
  out[3] = heights[0];
  return 0;
}

extern "C" int jpeg_decode(void* state, const unsigned char* data,
                           long long length, unsigned char* dst,
                           long long pitch, int gray, void* stream) {
  int s = ready();
  if (s != 0) return s;
  nvjpegImage_t image;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = nullptr;
    image.pitch[c] = 0;
  }
  image.channel[0] = dst;
  image.pitch[0] = pitch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t status = nvjpegDecode(
      handle, static_cast<nvjpegJpegState_t>(state), data,
      static_cast<size_t>(length),
      gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &image, st);
  if (status != NVJPEG_STATUS_SUCCESS) return static_cast<int>(status);
  cudaError_t e = cudaStreamSynchronize(st);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return 0;
}

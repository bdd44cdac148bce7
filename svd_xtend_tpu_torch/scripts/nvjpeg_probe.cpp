// nvJPEG against libjpeg's decode (probe_nvjpeg.py): decodes a file with
// nvJPEG from the CUDA toolkit, either to RGB by nvJPEG itself (mode 0) or
// to its stored planes, upsampled and converted to RGB as libjpeg does
// (mode 1, the frame loader's ycc_planes_to_rgb), then resizes and
// normalises with the frame loader's resize_normalize. Built with g++ by
// the probe on a machine with the toolkit.
#define SVDX_BUILTIN_JPEG
#include "../native/frame_loader.cpp"

#include <cuda_runtime.h>
#include <nvjpeg.h>

extern "C" int probe_decode_resize(const char* path, int mode, int out_w, int out_h,
                                   float* out) {
  static nvjpegHandle_t handle = nullptr;
  static nvjpegJpegState_t state = nullptr;
  if (handle == nullptr && (nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS ||
                            nvjpegJpegStateCreate(handle, &state) != NVJPEG_STATUS_SUCCESS))
    return 1;
  std::vector<unsigned char> data;
  if (!read_file(path, data)) return 2;
  int ncomp = 0, ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t sub;
  if (nvjpegGetImageInfo(handle, data.data(), data.size(), &ncomp, &sub, ws, hs) !=
          NVJPEG_STATUS_SUCCESS || ncomp != 3)
    return 3;
  const int w = ws[0], h = hs[0];
  const int planes = mode == 0 ? 1 : 3;
  size_t sizes[3], total = 0;
  for (int i = 0; i < planes; ++i) {
    sizes[i] = mode == 0 ? static_cast<size_t>(w) * 3 * h : static_cast<size_t>(ws[i]) * hs[i];
    total += sizes[i];
  }
  unsigned char* dbuf = nullptr;
  if (cudaMalloc(&dbuf, total) != cudaSuccess) return 4;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  size_t off = 0;
  for (int i = 0; i < planes; ++i) {
    img.channel[i] = dbuf + off;
    img.pitch[i] = mode == 0 ? static_cast<unsigned int>(w) * 3 : static_cast<unsigned int>(ws[i]);
    off += sizes[i];
  }
  std::vector<unsigned char> host(total), rgb(static_cast<size_t>(w) * h * 3);
  const bool ok =
      nvjpegDecode(handle, state, data.data(), data.size(),
                   mode == 0 ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_UNCHANGED, &img, nullptr) ==
          NVJPEG_STATUS_SUCCESS &&
      cudaMemcpy(host.data(), dbuf, total, cudaMemcpyDeviceToHost) == cudaSuccess;
  cudaFree(dbuf);
  if (!ok) return 5;
  if (mode == 0) {
    rgb = host;
  } else if (!ycc_planes_to_rgb(host.data(), host.data() + sizes[0],
                                host.data() + sizes[0] + sizes[1], w, h, ws[1], hs[1],
                                rgb.data())) {
    return 6;
  }
  resize_normalize(rgb, w, h, out_w, out_h, out);
  return 0;
}

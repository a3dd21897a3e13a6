// Native NIfTI-1 batch decoder with a worker thread pool.
//
// The reference feeds its models through 32 forked DataLoader worker
// processes doing nibabel + torch math per sample (reference:
// pkg/utils/dataloader.py:183-321, train_pet_cnn.py:155-164). Here the
// host-side hot path is this C++ library: gzip inflate + NIfTI parse +
// dtype cast + scl_slope/inter scaling directly into the caller's batch
// buffer, fanned out over a persistent thread pool with no Python on the
// decode path (ctypes releases the GIL for the duration of the call).
//
// The PyTorch port's own copy of the JAX package's decoder
// (native/nifti_io.cc), byte for byte in its code, so both give the same
// bits when built with the same flags on one host.
//
// Exposed C ABI (see multimodal_alzheimer_tpu_torch/data/native_io.py):
//   mmalz_nifti_shape(path, dims_out[8])            -> 0 on success
//   mmalz_nifti_decode(path, out, capacity)         -> voxels or -errno
//   mmalz_nifti_decode_batch(paths, n, out, stride) -> 0 on success
//
// Build: at first use, by data/native_io.py (g++ -O3 -march=native -fPIC
// -std=c++17 -shared -lz -lpthread, into the package's _build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <atomic>
#include <zlib.h>

namespace {

constexpr int kHeaderSize = 348;

struct NiftiHeader {
  int16_t ndim;
  int64_t dims[7];
  int16_t datatype;
  int32_t vox_offset;
  float scl_slope;
  float scl_inter;
};

// Read a whole file, inflating if gzip (magic 0x1f 0x8b).
bool ReadAll(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(size);
  if (fread(raw.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return false;
  }
  fclose(f);

  if (size >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 16) != Z_OK) return false;
    out->clear();
    out->resize(std::max<long>(size * 4, 1 << 20));
    zs.next_in = raw.data();
    zs.avail_in = size;
    size_t written = 0;
    int ret = Z_OK;
    while (ret != Z_STREAM_END) {
      if (written == out->size()) out->resize(out->size() * 2);
      zs.next_out = out->data() + written;
      zs.avail_out = out->size() - written;
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret != Z_OK && ret != Z_STREAM_END) {
        inflateEnd(&zs);
        return false;
      }
      written = out->size() - zs.avail_out;
    }
    inflateEnd(&zs);
    out->resize(written);
    return true;
  }
  *out = std::move(raw);
  return true;
}

bool ParseHeader(const uint8_t* buf, size_t len, NiftiHeader* hdr) {
  if (len < static_cast<size_t>(kHeaderSize)) return false;
  int32_t sizeof_hdr;
  memcpy(&sizeof_hdr, buf, 4);
  if (sizeof_hdr != kHeaderSize) return false;  // big-endian unsupported
  int16_t dim[8];
  memcpy(dim, buf + 40, 16);
  hdr->ndim = dim[0];
  if (hdr->ndim < 1 || hdr->ndim > 7) return false;
  for (int i = 0; i < 7; ++i) hdr->dims[i] = (i < hdr->ndim) ? dim[i + 1] : 1;
  memcpy(&hdr->datatype, buf + 70, 2);
  float vox_offset;
  memcpy(&vox_offset, buf + 108, 4);
  hdr->vox_offset = static_cast<int32_t>(vox_offset);
  memcpy(&hdr->scl_slope, buf + 112, 4);
  memcpy(&hdr->scl_inter, buf + 116, 4);
  if (memcmp(buf + 344, "n+1", 3) != 0) return false;
  return true;
}

template <typename T>
void CastCopy(const uint8_t* src, float* dst, int64_t n, float slope,
              float inter) {
  const T* in = reinterpret_cast<const T*>(src);
  if (slope == 0.f || (slope == 1.f && inter == 0.f)) {
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(in[i]);
  } else {
    for (int64_t i = 0; i < n; ++i)
      dst[i] = static_cast<float>(in[i]) * slope + inter;
  }
}

int64_t DecodeInto(const char* path, float* out, int64_t capacity) {
  std::vector<uint8_t> buf;
  if (!ReadAll(path, &buf)) return -1;
  NiftiHeader hdr;
  if (!ParseHeader(buf.data(), buf.size(), &hdr)) return -2;
  int64_t n = 1;
  for (int i = 0; i < hdr.ndim; ++i) n *= hdr.dims[i];
  if (n > capacity) return -3;
  const uint8_t* data = buf.data() + hdr.vox_offset;
  size_t avail = buf.size() - hdr.vox_offset;
  float slope = hdr.scl_slope;
  float inter = hdr.scl_inter;
  if (slope != slope) slope = 1.f;  // NaN -> identity
  if (inter != inter) inter = 0.f;

  auto need = [&](size_t esz) { return avail >= esz * n; };
  switch (hdr.datatype) {
    case 2:  if (!need(1)) return -4; CastCopy<uint8_t>(data, out, n, slope, inter); break;
    case 4:  if (!need(2)) return -4; CastCopy<int16_t>(data, out, n, slope, inter); break;
    case 8:  if (!need(4)) return -4; CastCopy<int32_t>(data, out, n, slope, inter); break;
    case 16: if (!need(4)) return -4; CastCopy<float>(data, out, n, slope, inter); break;
    case 64: if (!need(8)) return -4; CastCopy<double>(data, out, n, slope, inter); break;
    case 256: if (!need(1)) return -4; CastCopy<int8_t>(data, out, n, slope, inter); break;
    case 512: if (!need(2)) return -4; CastCopy<uint16_t>(data, out, n, slope, inter); break;
    case 768: if (!need(4)) return -4; CastCopy<uint32_t>(data, out, n, slope, inter); break;
    default: return -5;
  }
  return n;
}

}  // namespace

extern "C" {

int mmalz_nifti_shape(const char* path, int64_t* dims_out) {
  std::vector<uint8_t> buf;
  if (!ReadAll(path, &buf)) return -1;
  NiftiHeader hdr;
  if (!ParseHeader(buf.data(), buf.size(), &hdr)) return -2;
  dims_out[0] = hdr.ndim;
  for (int i = 0; i < 7; ++i) dims_out[i + 1] = hdr.dims[i];
  return 0;
}

int64_t mmalz_nifti_decode(const char* path, float* out, int64_t capacity) {
  return DecodeInto(path, out, capacity);
}

// Single-read decode: inflate once, return dims through dims_out[8]
// (ndim, d0..d6) and voxel count (or -errno). Avoids the shape()+decode()
// double inflate for gzipped files.
int64_t mmalz_nifti_decode_auto(const char* path, float* out,
                                int64_t capacity, int64_t* dims_out) {
  std::vector<uint8_t> buf;
  if (!ReadAll(path, &buf)) return -1;
  NiftiHeader hdr;
  if (!ParseHeader(buf.data(), buf.size(), &hdr)) return -2;
  dims_out[0] = hdr.ndim;
  for (int i = 0; i < 7; ++i) dims_out[i + 1] = hdr.dims[i];
  int64_t n = 1;
  for (int i = 0; i < hdr.ndim; ++i) n *= hdr.dims[i];
  if (n > capacity) return -3;
  const uint8_t* data = buf.data() + hdr.vox_offset;
  size_t avail = buf.size() - hdr.vox_offset;
  float slope = hdr.scl_slope;
  float inter = hdr.scl_inter;
  if (slope != slope) slope = 1.f;
  if (inter != inter) inter = 0.f;
  auto need = [&](size_t esz) { return avail >= esz * (size_t)n; };
  switch (hdr.datatype) {
    case 2:  if (!need(1)) return -4; CastCopy<uint8_t>(data, out, n, slope, inter); break;
    case 4:  if (!need(2)) return -4; CastCopy<int16_t>(data, out, n, slope, inter); break;
    case 8:  if (!need(4)) return -4; CastCopy<int32_t>(data, out, n, slope, inter); break;
    case 16: if (!need(4)) return -4; CastCopy<float>(data, out, n, slope, inter); break;
    case 64: if (!need(8)) return -4; CastCopy<double>(data, out, n, slope, inter); break;
    case 256: if (!need(1)) return -4; CastCopy<int8_t>(data, out, n, slope, inter); break;
    case 512: if (!need(2)) return -4; CastCopy<uint16_t>(data, out, n, slope, inter); break;
    case 768: if (!need(4)) return -4; CastCopy<uint32_t>(data, out, n, slope, inter); break;
    default: return -5;
  }
  return n;
}

// Decode n files concurrently; file i lands at out + i*stride (stride in
// floats). Returns 0 on success, or -(index+1) of the first failed file.
int mmalz_nifti_decode_batch(const char** paths, int n, float* out,
                             int64_t stride, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int64_t got = DecodeInto(paths[i], out + i * stride, stride);
      if (got < 0) {
        int expected = 0;
        failed.compare_exchange_strong(expected, -(i + 1));
      }
    }
  };
  int threads = std::min(n, num_threads);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failed.load();
}

}  // extern "C"

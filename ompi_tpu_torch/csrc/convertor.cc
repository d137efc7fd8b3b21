// libtpuconvertor — native pack/unpack kernels for the datatype engine.
//
// ≈ the hot inner loops of the reference's opal/datatype convertor
// (opal_convertor_pack/unpack [bin], SURVEY.md §2.1): walk a committed
// iovec program — (offset, length) blocks per element, elements strided
// by the datatype extent — and gather (pack) or scatter (unpack)
// between the user buffer and a contiguous wire buffer.  The Python
// layer (ompi_tpu_torch/ddt/convertor.py) keeps the vectorized-numpy and
// torch.take paths for device-resident data; this library is the
// host-memory fast path the C API and DCN transport use, where the
// per-block memcpy beats building a byte-index array.
//
// All bounds are validated by the caller (the Python layer mirrors the
// reference's convertor-prepare checks); these loops assume validity.

#include <cstdint>
#include <cstring>

extern "C" {

// Gather: user buffer -> contiguous wire buffer.
//   base    user buffer origin (already adjusted for MPI bottom/origin)
//   dst     wire buffer, sum(lengths) * count bytes
//   offsets/lengths  the iovec program, nblocks entries, element-relative
//   count   element repetitions; element e lives at base + e * extent
void tpuconv_pack(const uint8_t *base, uint8_t *dst, const int64_t *offsets,
                  const int64_t *lengths, int64_t nblocks, int64_t count,
                  int64_t extent) {
  uint8_t *out = dst;
  for (int64_t e = 0; e < count; ++e) {
    const uint8_t *src = base + e * extent;
    for (int64_t b = 0; b < nblocks; ++b) {
      memcpy(out, src + offsets[b], (size_t)lengths[b]);
      out += lengths[b];
    }
  }
}

// Scatter: contiguous wire buffer -> user buffer.
void tpuconv_unpack(uint8_t *base, const uint8_t *src, const int64_t *offsets,
                    const int64_t *lengths, int64_t nblocks, int64_t count,
                    int64_t extent) {
  const uint8_t *in = src;
  for (int64_t e = 0; e < count; ++e) {
    uint8_t *dst = base + e * extent;
    for (int64_t b = 0; b < nblocks; ++b) {
      memcpy(dst + offsets[b], in, (size_t)lengths[b]);
      in += lengths[b];
    }
  }
}

// Elementwise strided copy (hvector-style fast path): count blocks of
// blocklen bytes, source stride sstride, destination stride dstride.
void tpuconv_copy_strided(const uint8_t *src, uint8_t *dst, int64_t count,
                          int64_t blocklen, int64_t sstride,
                          int64_t dstride) {
  for (int64_t i = 0; i < count; ++i)
    memcpy(dst + i * dstride, src + i * sstride, (size_t)blocklen);
}

int tpuconv_version(void) { return 1; }

}  // extern "C"

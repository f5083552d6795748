// recordstore — a minimal mmap'd record-shard store.
//
// The port's copy of runtime/recordstore.cc, byte-for-byte the same ABI
// and on-disk format; the port builds it with g++ into build/recordstore/
// (mobilenet_yolo_tpu_torch/data/records.py). It stands in for the
// reference's LMDB dependency (folder2lmdb.py:59-64,319-353): the input
// pipeline needs exactly "random access to the i-th byte blob", so instead
// of a B-tree KV store it keeps a flat index + mmap'd payload, which the
// kernel page cache serves at memory speed with no serialization.
//
// On-disk layout (directory, mirroring the lmdb-directory contract):
//   index.bin : uint64 little-endian pairs (offset, length) per record
//   data.bin  : concatenated payload blobs
//   meta.json : written by the Python layer (record schema, counts)
//
// Exposed as a C ABI for ctypes; a pure-Python reader reads the same
// format (mobilenet_yolo_tpu_torch/data/records.py, force_python=True).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Index {
  uint64_t offset;
  uint64_t length;
};

}  // namespace

extern "C" {

struct RS {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t data_size = 0;
  std::vector<Index> index;
};

RS* rs_open(const char* dir) {
  std::string base(dir);
  std::string index_path = base + "/index.bin";
  std::string data_path = base + "/data.bin";

  FILE* idx = std::fopen(index_path.c_str(), "rb");
  if (!idx) return nullptr;
  std::fseek(idx, 0, SEEK_END);
  long idx_size = std::ftell(idx);
  std::fseek(idx, 0, SEEK_SET);
  if (idx_size < 0 || idx_size % sizeof(Index) != 0) {
    std::fclose(idx);
    return nullptr;
  }
  auto* rs = new RS();
  rs->index.resize(idx_size / sizeof(Index));
  if (!rs->index.empty() &&
      std::fread(rs->index.data(), sizeof(Index), rs->index.size(), idx) !=
          rs->index.size()) {
    std::fclose(idx);
    delete rs;
    return nullptr;
  }
  std::fclose(idx);

  rs->fd = ::open(data_path.c_str(), O_RDONLY);
  if (rs->fd < 0) {
    delete rs;
    return nullptr;
  }
  struct stat st;
  if (fstat(rs->fd, &st) != 0) {
    ::close(rs->fd);
    delete rs;
    return nullptr;
  }
  rs->data_size = static_cast<size_t>(st.st_size);
  if (rs->data_size > 0) {
    void* p = mmap(nullptr, rs->data_size, PROT_READ, MAP_SHARED, rs->fd, 0);
    if (p == MAP_FAILED) {
      ::close(rs->fd);
      delete rs;
      return nullptr;
    }
    // random access pattern: let the kernel know
    madvise(p, rs->data_size, MADV_RANDOM);
    rs->data = static_cast<const uint8_t*>(p);
  }
  return rs;
}

uint64_t rs_len(RS* rs) { return rs ? rs->index.size() : 0; }

const uint8_t* rs_get(RS* rs, uint64_t i, uint64_t* len) {
  if (!rs || i >= rs->index.size()) {
    if (len) *len = 0;
    return nullptr;
  }
  const Index& e = rs->index[i];
  if (e.offset + e.length > rs->data_size) {
    if (len) *len = 0;
    return nullptr;
  }
  if (len) *len = e.length;
  return rs->data + e.offset;
}

void rs_close(RS* rs) {
  if (!rs) return;
  if (rs->data) munmap(const_cast<uint8_t*>(rs->data), rs->data_size);
  if (rs->fd >= 0) ::close(rs->fd);
  delete rs;
}

// ---------------------------------------------------------------- writer --

struct RSW {
  FILE* data = nullptr;
  FILE* index = nullptr;
  uint64_t offset = 0;
};

RSW* rsw_create(const char* dir) {
  std::string base(dir);
  FILE* d = std::fopen((base + "/data.bin").c_str(), "wb");
  if (!d) return nullptr;
  FILE* x = std::fopen((base + "/index.bin").c_str(), "wb");
  if (!x) {
    std::fclose(d);
    return nullptr;
  }
  auto* w = new RSW();
  w->data = d;
  w->index = x;
  return w;
}

int rsw_append(RSW* w, const uint8_t* buf, uint64_t len) {
  if (!w) return -1;
  if (len && std::fwrite(buf, 1, len, w->data) != len) return -1;
  Index e{w->offset, len};
  if (std::fwrite(&e, sizeof(Index), 1, w->index) != 1) return -1;
  w->offset += len;
  return 0;
}

int rsw_finish(RSW* w) {
  if (!w) return -1;
  int rc = 0;
  rc |= std::fflush(w->data);
  rc |= std::fflush(w->index);
  rc |= fsync(fileno(w->data));
  rc |= fsync(fileno(w->index));
  rc |= std::fclose(w->data);
  rc |= std::fclose(w->index);
  delete w;
  return rc;
}

}  // extern "C"

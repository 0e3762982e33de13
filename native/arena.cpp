// Arena serialization library for checkpoint/restart.
//
// JAX analog of the reference's DataContainer arena
// (src/base/DataContainer.{h,cpp}: arrays registered as chunks, packed into
// one contiguous aligned block with a check-word, dumped raw by
// OutputManagerComposite.cpp:108-290).  This library packs named arrays
// into a single aligned arena buffer with a header, offset table and
// per-array FNV-1a checksums, using multithreaded memcpy for large arrays.
// Exposed to Python through ctypes (no pybind11 dependency).
//
// Layout:
//   [Header][Entry x n][name bytes...pad to 64][payload 0][pad][payload 1]...
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread arena.cpp -o libtempest_arena.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x54454D5045535431ULL;  // "TEMPEST1"
constexpr int64_t kAlign = 64;

struct Header {
  uint64_t magic;
  uint64_t version;
  uint64_t n_arrays;
  uint64_t total_bytes;
};

struct Entry {
  uint64_t name_offset;   // offset of NUL-terminated name
  uint64_t name_len;
  uint64_t data_offset;   // offset of payload (64-byte aligned)
  uint64_t data_bytes;
  uint64_t checksum;      // FNV-1a over payload
  uint64_t reserved;
};

inline int64_t align_up(int64_t x) { return (x + kAlign - 1) & ~(kAlign - 1); }

uint64_t fnv1a(const uint8_t* p, int64_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (int64_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// Parallel memcpy: splits a large copy over hardware threads.
void par_memcpy(void* dst, const void* src, int64_t n) {
  const int64_t kParallelThreshold = 8 << 20;
  if (n < kParallelThreshold) {
    std::memcpy(dst, src, n);
    return;
  }
  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 2) nt = 2;
  if (nt > 16) nt = 16;
  int64_t chunk = align_up(n / nt);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; t++) {
    int64_t off = (int64_t)t * chunk;
    if (off >= n) break;
    int64_t len = std::min(chunk, n - off);
    threads.emplace_back([=] {
      std::memcpy((uint8_t*)dst + off, (const uint8_t*)src + off, len);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Size of the arena required for the given arrays.
int64_t ta_required_bytes(int64_t n, const char** names,
                          const int64_t* nbytes) {
  int64_t off = sizeof(Header) + n * (int64_t)sizeof(Entry);
  for (int64_t i = 0; i < n; i++) off += (int64_t)strlen(names[i]) + 1;
  off = align_up(off);
  for (int64_t i = 0; i < n; i++) off = align_up(off + nbytes[i]);
  return off;
}

// Pack arrays into `out` (capacity must be >= ta_required_bytes).
// Returns total bytes written, or -1 on overflow.
int64_t ta_pack(int64_t n, const char** names, const void** data,
                const int64_t* nbytes, void* out, int64_t capacity) {
  int64_t need = ta_required_bytes(n, names, nbytes);
  if (need > capacity) return -1;
  uint8_t* base = (uint8_t*)out;
  Header* h = (Header*)base;
  h->magic = kMagic;
  h->version = 1;
  h->n_arrays = (uint64_t)n;
  Entry* entries = (Entry*)(base + sizeof(Header));

  int64_t name_off = sizeof(Header) + n * (int64_t)sizeof(Entry);
  for (int64_t i = 0; i < n; i++) {
    int64_t len = (int64_t)strlen(names[i]);
    entries[i].name_offset = (uint64_t)name_off;
    entries[i].name_len = (uint64_t)len;
    std::memcpy(base + name_off, names[i], len + 1);
    name_off += len + 1;
  }
  int64_t off = align_up(name_off);
  for (int64_t i = 0; i < n; i++) {
    entries[i].data_offset = (uint64_t)off;
    entries[i].data_bytes = (uint64_t)nbytes[i];
    par_memcpy(base + off, data[i], nbytes[i]);
    entries[i].checksum = fnv1a(base + off, nbytes[i]);
    entries[i].reserved = 0;
    off = align_up(off + nbytes[i]);
  }
  h->total_bytes = (uint64_t)off;
  return off;
}

// Number of arrays in an arena (-1 if invalid).
int64_t ta_count(const void* arena, int64_t nbytes) {
  if (nbytes < (int64_t)sizeof(Header)) return -1;
  const Header* h = (const Header*)arena;
  if (h->magic != kMagic) return -1;
  return (int64_t)h->n_arrays;
}

// Query entry i: copies name into name_out (cap name_cap incl NUL),
// stores payload size; returns 0 ok / -1 error.
int64_t ta_entry(const void* arena, int64_t i, char* name_out,
                 int64_t name_cap, int64_t* nbytes_out) {
  const Header* h = (const Header*)arena;
  if (h->magic != kMagic || i < 0 || (uint64_t)i >= h->n_arrays) return -1;
  const Entry* e = (const Entry*)((const uint8_t*)arena + sizeof(Header)) + i;
  int64_t len = (int64_t)e->name_len;
  if (len + 1 > name_cap) return -1;
  std::memcpy(name_out, (const uint8_t*)arena + e->name_offset, len + 1);
  *nbytes_out = (int64_t)e->data_bytes;
  return 0;
}

// Unpack entry i into dst (verifying the checksum).
// Returns 0 ok / -1 bad args / -2 checksum mismatch (data still copied).
int64_t ta_unpack(const void* arena, int64_t i, void* dst,
                  int64_t dst_bytes) {
  const Header* h = (const Header*)arena;
  if (h->magic != kMagic || i < 0 || (uint64_t)i >= h->n_arrays) return -1;
  const Entry* e = (const Entry*)((const uint8_t*)arena + sizeof(Header)) + i;
  if ((int64_t)e->data_bytes != dst_bytes) return -1;
  const uint8_t* src = (const uint8_t*)arena + e->data_offset;
  par_memcpy(dst, src, dst_bytes);
  if (fnv1a(src, dst_bytes) != e->checksum) return -2;
  return 0;
}

}  // extern "C"

// BLAKE3 one-shot hashing — the node runtime's hottest CPU path.
//
// Native twin of core/hashing.py (same from-spec algorithm, same tree
// rules); compiled by native/__init__.py into build/libsmtpu_blake3-<hash>.so
// and loaded via ctypes with the Python implementation as fallback + test
// oracle. A copy of the JAX package's native/blake3.cpp.
// Every gossip message id, codec content id, address and merkle node
// rides this (reference hash/hash.go uses the native BLAKE3 crate the
// same way).
//
// Build (native/__init__.py): g++ -O3 -shared -fPIC -o <out>.so blake3.cpp

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

constexpr int MSG_PERM[16] = {2, 6,  3,  10, 7, 0,  4,  13,
                              1, 11, 12, 5,  9, 14, 15, 8};

constexpr uint32_t CHUNK_START = 1;
constexpr uint32_t CHUNK_END = 2;
constexpr uint32_t PARENT = 4;
constexpr uint32_t ROOT = 8;
constexpr uint32_t KEYED_HASH = 16;

constexpr size_t BLOCK_LEN = 64;
constexpr size_t CHUNK_LEN = 1024;

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static inline void g(uint32_t *st, int a, int b, int c, int d, uint32_t mx,
                     uint32_t my) {
  st[a] = st[a] + st[b] + mx;
  st[d] = rotr(st[d] ^ st[a], 16);
  st[c] = st[c] + st[d];
  st[b] = rotr(st[b] ^ st[c], 12);
  st[a] = st[a] + st[b] + my;
  st[d] = rotr(st[d] ^ st[a], 8);
  st[c] = st[c] + st[d];
  st[b] = rotr(st[b] ^ st[c], 7);
}

static void compress(const uint32_t cv[8], const uint32_t block[16],
                     uint64_t counter, uint32_t block_len, uint32_t flags,
                     uint32_t out[16]) {
  uint32_t st[16];
  uint32_t m[16];
  std::memcpy(st, cv, 32);
  std::memcpy(st + 8, IV, 16);
  st[12] = static_cast<uint32_t>(counter);
  st[13] = static_cast<uint32_t>(counter >> 32);
  st[14] = block_len;
  st[15] = flags;
  std::memcpy(m, block, 64);
  for (int round = 0;; ++round) {
    g(st, 0, 4, 8, 12, m[0], m[1]);
    g(st, 1, 5, 9, 13, m[2], m[3]);
    g(st, 2, 6, 10, 14, m[4], m[5]);
    g(st, 3, 7, 11, 15, m[6], m[7]);
    g(st, 0, 5, 10, 15, m[8], m[9]);
    g(st, 1, 6, 11, 12, m[10], m[11]);
    g(st, 2, 7, 8, 13, m[12], m[13]);
    g(st, 3, 4, 9, 14, m[14], m[15]);
    if (round == 6) break;
    uint32_t p[16];
    for (int i = 0; i < 16; ++i) p[i] = m[MSG_PERM[i]];
    std::memcpy(m, p, 64);
  }
  for (int i = 0; i < 8; ++i) {
    out[i] = st[i] ^ st[i + 8];
    out[i + 8] = st[i + 8] ^ cv[i];
  }
}

static inline void load_block(const uint8_t *p, size_t len,
                              uint32_t block[16]) {
  uint8_t buf[BLOCK_LEN] = {0};
  std::memcpy(buf, p, len);
  for (int i = 0; i < 16; ++i) {
    block[i] = static_cast<uint32_t>(buf[4 * i]) |
               (static_cast<uint32_t>(buf[4 * i + 1]) << 8) |
               (static_cast<uint32_t>(buf[4 * i + 2]) << 16) |
               (static_cast<uint32_t>(buf[4 * i + 3]) << 24);
  }
}

struct Output {
  uint32_t cv[8];
  uint32_t block[16];
  uint64_t counter;
  uint32_t block_len;
  uint32_t flags;
};

// compress one whole 1024-byte chunk straight to its chaining value
static void chunk_cv(const uint8_t *p, size_t len, uint64_t chunk_counter,
                     const uint32_t key[8], uint32_t base_flags,
                     uint32_t cv_out[8]) {
  uint32_t cv[8];
  std::memcpy(cv, key, 32);
  size_t off = 0;
  int block_idx = 0;
  while (len - off > BLOCK_LEN) {
    uint32_t block[16];
    load_block(p + off, BLOCK_LEN, block);
    uint32_t flags = base_flags | (block_idx == 0 ? CHUNK_START : 0);
    uint32_t out[16];
    compress(cv, block, chunk_counter, BLOCK_LEN, flags, out);
    std::memcpy(cv, out, 32);
    off += BLOCK_LEN;
    ++block_idx;
  }
  uint32_t block[16];
  load_block(p + off, len - off, block);
  uint32_t flags = base_flags | (block_idx == 0 ? CHUNK_START : 0) | CHUNK_END;
  uint32_t out[16];
  compress(cv, block, chunk_counter, static_cast<uint32_t>(len - off), flags,
           out);
  std::memcpy(cv_out, out, 32);
}

// the FINAL (possibly partial) chunk keeps its pre-finalization state so
// the root flag can be applied at output time
static void chunk_output(const uint8_t *p, size_t len, uint64_t chunk_counter,
                         const uint32_t key[8], uint32_t base_flags,
                         Output *out) {
  uint32_t cv[8];
  std::memcpy(cv, key, 32);
  size_t off = 0;
  int block_idx = 0;
  while (len > 0 && len - off > BLOCK_LEN) {
    uint32_t block[16];
    load_block(p + off, BLOCK_LEN, block);
    uint32_t flags = base_flags | (block_idx == 0 ? CHUNK_START : 0);
    uint32_t cout[16];
    compress(cv, block, chunk_counter, BLOCK_LEN, flags, cout);
    std::memcpy(cv, cout, 32);
    off += BLOCK_LEN;
    ++block_idx;
  }
  std::memcpy(out->cv, cv, 32);
  load_block(p + off, len - off, out->block);
  out->counter = chunk_counter;
  out->block_len = static_cast<uint32_t>(len - off);
  out->flags = base_flags | (block_idx == 0 ? CHUNK_START : 0) | CHUNK_END;
}

static void parent_output(const uint32_t left[8], const uint32_t right[8],
                          const uint32_t key[8], uint32_t base_flags,
                          Output *out) {
  std::memcpy(out->cv, key, 32);
  std::memcpy(out->block, left, 32);
  std::memcpy(out->block + 8, right, 32);
  out->counter = 0;
  out->block_len = BLOCK_LEN;
  out->flags = base_flags | PARENT;
}

}  // namespace

extern "C" {

// One-shot BLAKE3. key32 may be null (unkeyed) or point at 32 bytes
// (keyed mode). Writes out_len bytes of root XOF output.
void smtpu_blake3(const uint8_t *data, size_t len, const uint8_t *key32,
                  uint8_t *out, size_t out_len) {
  uint32_t key[8];
  uint32_t base_flags = 0;
  if (key32 != nullptr) {
    for (int i = 0; i < 8; ++i) {
      key[i] = static_cast<uint32_t>(key32[4 * i]) |
               (static_cast<uint32_t>(key32[4 * i + 1]) << 8) |
               (static_cast<uint32_t>(key32[4 * i + 2]) << 16) |
               (static_cast<uint32_t>(key32[4 * i + 3]) << 24);
    }
    base_flags = KEYED_HASH;
  } else {
    std::memcpy(key, IV, 32);
  }

  // tree: full chunks push CVs onto the merge stack; the last (possibly
  // partial/empty) chunk becomes the root candidate (hashing.py Hasher)
  uint32_t stack[54][8];  // 2^54 chunks ≫ any input
  int depth = 0;
  uint64_t total_chunks = 0;

  size_t off = 0;
  while (len - off > CHUNK_LEN) {
    uint32_t cv[8];
    chunk_cv(data + off, CHUNK_LEN, total_chunks, key, base_flags, cv);
    ++total_chunks;
    uint64_t total = total_chunks;
    while ((total & 1) == 0) {
      Output po;
      parent_output(stack[--depth], cv, key, base_flags, &po);
      uint32_t cout[16];
      compress(po.cv, po.block, po.counter, po.block_len, po.flags, cout);
      std::memcpy(cv, cout, 32);
      total >>= 1;
    }
    std::memcpy(stack[depth++], cv, 32);
    off += CHUNK_LEN;
  }

  Output root;
  chunk_output(data + off, len - off, total_chunks, key, base_flags, &root);
  for (int i = depth - 1; i >= 0; --i) {
    uint32_t cout[16];
    compress(root.cv, root.block, root.counter, root.block_len, root.flags,
             cout);
    uint32_t cv[8];
    std::memcpy(cv, cout, 32);
    parent_output(stack[i], cv, key, base_flags, &root);
  }

  uint64_t block_counter = 0;
  size_t produced = 0;
  while (produced < out_len) {
    uint32_t wide[16];
    compress(root.cv, root.block, block_counter, root.block_len,
             root.flags | ROOT, wide);
    uint8_t bytes[64];
    for (int i = 0; i < 16; ++i) {
      bytes[4 * i] = static_cast<uint8_t>(wide[i]);
      bytes[4 * i + 1] = static_cast<uint8_t>(wide[i] >> 8);
      bytes[4 * i + 2] = static_cast<uint8_t>(wide[i] >> 16);
      bytes[4 * i + 3] = static_cast<uint8_t>(wide[i] >> 24);
    }
    size_t take = out_len - produced < 64 ? out_len - produced : 64;
    std::memcpy(out + produced, bytes, take);
    produced += take;
    ++block_counter;
  }
}

}  // extern "C"

// trajstore — append-only compressed record store for DAgger trajectories.
//
// Native replacement for the reference's LMDB + zlib(msgpack) pipeline
// (`dagger_trainer.py:36-37,336-356,492`: Pool(8) compress -> lmdb txn.put
// with sequential integer keys). Design:
//
//   * one shard per writer rank: <dir>/shard_<rank>.bin + .idx — no
//     cross-process locking, no barrier/sleep staggering (the reference
//     needs `time.sleep(1*rank)` at `dagger_trainer.py:346`);
//   * .idx is a flat array of {uint64 offset, uint64 comp_size,
//     uint64 raw_size} records; .bin is concatenated zlib streams;
//   * batch append compresses records on a std::thread pool, then performs
//     one sequential write (replaces multiprocessing.Pool(8));
//   * readers mmap-free: plain pread, safe to open while a writer appends
//     (records become visible after ts_flush).
//
// C ABI for ctypes; no C++ types cross the boundary.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct IndexEntry {
  uint64_t offset;
  uint64_t comp_size;
  uint64_t raw_size;
};

struct Writer {
  FILE* bin = nullptr;
  FILE* idx = nullptr;
  uint64_t offset = 0;
  std::mutex mu;
};

struct Shard {
  std::string bin_path;
  std::vector<IndexEntry> entries;
};

struct Reader {
  std::vector<Shard> shards;
  // flattened record id -> (shard, local index)
  std::vector<std::pair<uint32_t, uint32_t>> map;
};

std::vector<uint8_t> compress_buf(const uint8_t* data, size_t len, int level) {
  uLongf bound = compressBound(len);
  std::vector<uint8_t> out(bound);
  compress2(out.data(), &bound, data, len, level);
  out.resize(bound);
  return out;
}

bool decompress_buf(const uint8_t* data, size_t comp, uint8_t* out,
                    size_t raw) {
  uLongf dst = raw;
  return uncompress(out, &dst, data, comp) == Z_OK && dst == raw;
}

}  // namespace

extern "C" {

void* ts_writer_open(const char* dir, int rank) {
  auto* w = new Writer();
  char path[4096];
  std::snprintf(path, sizeof(path), "%s/shard_%d.bin", dir, rank);
  w->bin = std::fopen(path, "ab");
  std::snprintf(path, sizeof(path), "%s/shard_%d.idx", dir, rank);
  w->idx = std::fopen(path, "ab");
  if (!w->bin || !w->idx) {
    if (w->bin) std::fclose(w->bin);
    if (w->idx) std::fclose(w->idx);
    delete w;
    return nullptr;
  }
  std::fseek(w->bin, 0, SEEK_END);
  w->offset = static_cast<uint64_t>(std::ftell(w->bin));
  return w;
}

// Compress `n` records in parallel and append them in order.
// Returns the number appended (== n on success).
int64_t ts_writer_append_batch(void* handle, int64_t n,
                               const uint8_t** bufs, const int64_t* lens,
                               int level, int num_threads) {
  auto* w = static_cast<Writer*>(handle);
  std::vector<std::vector<uint8_t>> comp(n);
  if (num_threads < 1) num_threads = 1;
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  int workers = static_cast<int>(
      std::min<int64_t>(n, static_cast<int64_t>(num_threads)));
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&] {
      for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        comp[i] = compress_buf(bufs[i], static_cast<size_t>(lens[i]), level);
      }
    });
  }
  for (auto& th : pool) th.join();

  std::lock_guard<std::mutex> lock(w->mu);
  for (int64_t i = 0; i < n; ++i) {
    IndexEntry e{w->offset, comp[i].size(), static_cast<uint64_t>(lens[i])};
    if (std::fwrite(comp[i].data(), 1, comp[i].size(), w->bin) !=
        comp[i].size())
      return i;
    if (std::fwrite(&e, sizeof(e), 1, w->idx) != 1) return i;
    w->offset += comp[i].size();
  }
  return n;
}

void ts_writer_flush(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  std::lock_guard<std::mutex> lock(w->mu);
  std::fflush(w->bin);
  std::fflush(w->idx);
}

void ts_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  std::fclose(w->bin);
  std::fclose(w->idx);
  delete w;
}

void* ts_reader_open(const char* dir, int max_ranks) {
  auto* r = new Reader();
  for (int rank = 0; rank < max_ranks; ++rank) {
    char path[4096];
    std::snprintf(path, sizeof(path), "%s/shard_%d.idx", dir, rank);
    FILE* f = std::fopen(path, "rb");
    if (!f) continue;
    Shard shard;
    IndexEntry e;
    while (std::fread(&e, sizeof(e), 1, f) == 1) shard.entries.push_back(e);
    std::fclose(f);
    std::snprintf(path, sizeof(path), "%s/shard_%d.bin", dir, rank);
    shard.bin_path = path;
    uint32_t sid = static_cast<uint32_t>(r->shards.size());
    for (uint32_t i = 0; i < shard.entries.size(); ++i)
      r->map.emplace_back(sid, i);
    r->shards.push_back(std::move(shard));
  }
  return r;
}

int64_t ts_reader_count(void* handle) {
  return static_cast<int64_t>(static_cast<Reader*>(handle)->map.size());
}

int64_t ts_reader_raw_size(void* handle, int64_t id) {
  auto* r = static_cast<Reader*>(handle);
  if (id < 0 || id >= static_cast<int64_t>(r->map.size())) return -1;
  auto [sid, li] = r->map[id];
  return static_cast<int64_t>(r->shards[sid].entries[li].raw_size);
}

int64_t ts_reader_get(void* handle, int64_t id, uint8_t* out,
                      int64_t capacity) {
  auto* r = static_cast<Reader*>(handle);
  if (id < 0 || id >= static_cast<int64_t>(r->map.size())) return -1;
  auto [sid, li] = r->map[id];
  const auto& e = r->shards[sid].entries[li];
  if (capacity < static_cast<int64_t>(e.raw_size)) return -2;
  FILE* f = std::fopen(r->shards[sid].bin_path.c_str(), "rb");
  if (!f) return -3;
  std::vector<uint8_t> comp(e.comp_size);
  std::fseek(f, static_cast<long>(e.offset), SEEK_SET);
  size_t got = std::fread(comp.data(), 1, e.comp_size, f);
  std::fclose(f);
  if (got != e.comp_size) return -4;
  if (!decompress_buf(comp.data(), e.comp_size, out, e.raw_size)) return -5;
  return static_cast<int64_t>(e.raw_size);
}

void ts_reader_close(void* handle) { delete static_cast<Reader*>(handle); }

}  // extern "C"

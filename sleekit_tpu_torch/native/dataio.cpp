// Native token-shard data loader for calibration / evaluation streams
// (the port's copy of sleekit_tpu/native/dataio.cpp).
//
// Format "SKT1": 16-byte header { magic 'SKT1', u32 dtype_size (2|4),
// u64 token_count } followed by raw little-endian tokens. Shards are
// memory-mapped; batch assembly (window gather + u16->i32 widening) is
// multithreaded, and a background prefetcher keeps a ring of ready
// batches ahead of the device so host IO never stalls a step.
//
// C ABI only (consumed via ctypes - no pybind11 dependency). The Python
// wrapper (sleekit_tpu_torch/native/dataio.py) has no fallback: its numpy
// plain versions exist only for the tests.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Shard {
  int fd = -1;
  const uint8_t* base = nullptr;  // mmap base
  size_t map_len = 0;
  uint32_t dtype_size = 0;        // 2 or 4
  uint64_t count = 0;             // tokens
  const uint8_t* data() const { return base + 16; }
};

std::mutex g_mu;
std::vector<Shard*> g_shards;

constexpr char kMagic[4] = {'S', 'K', 'T', '1'};

void widen_range(const Shard& s, uint64_t start, int64_t n, int32_t* out) {
  // Gather [start, start+n) tokens (wrapping at shard end) into int32.
  uint64_t c = s.count;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t idx = (start + static_cast<uint64_t>(i)) % c;
    if (s.dtype_size == 2) {
      uint16_t v;
      std::memcpy(&v, s.data() + idx * 2, 2);
      out[i] = static_cast<int32_t>(v);
    } else {
      uint32_t v;
      std::memcpy(&v, s.data() + idx * 4, 4);
      out[i] = static_cast<int32_t>(v);
    }
  }
}

template <typename Fn>
void parallel_rows(int64_t rows, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, rows));
  if (nt == 1) {
    for (int64_t r = 0; r < rows; ++r) fn(r);
    return;
  }
  std::vector<std::thread> ts;
  std::atomic<int64_t> next{0};
  for (int64_t t = 0; t < nt; ++t)
    ts.emplace_back([&] {
      for (int64_t r; (r = next.fetch_add(1)) < rows;) fn(r);
    });
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// ---- shard writer ---------------------------------------------------------

int skt_write(const char* path, const int32_t* tokens, int64_t count,
              int32_t dtype_size) {
  if (dtype_size != 2 && dtype_size != 4) return -1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  uint32_t ds = static_cast<uint32_t>(dtype_size);
  uint64_t c = static_cast<uint64_t>(count);
  if (std::fwrite(kMagic, 1, 4, f) != 4 ||
      std::fwrite(&ds, 4, 1, f) != 1 || std::fwrite(&c, 8, 1, f) != 1) {
    std::fclose(f);
    return -3;
  }
  int rc = 0;
  if (dtype_size == 4) {
    if (std::fwrite(tokens, 4, count, f) != static_cast<size_t>(count))
      rc = -3;
  } else {
    std::vector<uint16_t> buf(4096);
    for (int64_t off = 0; off < count && rc == 0; off += 4096) {
      int64_t n = std::min<int64_t>(4096, count - off);
      for (int64_t i = 0; i < n; ++i)
        buf[i] = static_cast<uint16_t>(tokens[off + i]);
      if (std::fwrite(buf.data(), 2, n, f) != static_cast<size_t>(n))
        rc = -3;
    }
  }
  std::fclose(f);
  return rc;
}

// ---- shard reader ---------------------------------------------------------

int64_t skt_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    ::close(fd);
    return -2;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return -3;
  }
  auto* s = new Shard;
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->map_len = st.st_size;
  if (std::memcmp(s->base, kMagic, 4) != 0) {
    ::munmap(base, st.st_size);
    ::close(fd);
    delete s;
    return -4;
  }
  std::memcpy(&s->dtype_size, s->base + 4, 4);
  std::memcpy(&s->count, s->base + 8, 8);
  if ((s->dtype_size != 2 && s->dtype_size != 4) ||
      16 + s->count * s->dtype_size > static_cast<uint64_t>(st.st_size)) {
    ::munmap(base, st.st_size);
    ::close(fd);
    delete s;
    return -5;
  }
  std::lock_guard<std::mutex> lk(g_mu);
  g_shards.push_back(s);
  return static_cast<int64_t>(g_shards.size() - 1);
}

int64_t skt_len(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (handle < 0 || handle >= static_cast<int64_t>(g_shards.size()) ||
      !g_shards[handle])
    return -1;
  return static_cast<int64_t>(g_shards[handle]->count);
}

int skt_close(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (handle < 0 || handle >= static_cast<int64_t>(g_shards.size()) ||
      !g_shards[handle])
    return -1;
  Shard* s = g_shards[handle];
  ::munmap(const_cast<uint8_t*>(s->base), s->map_len);
  ::close(s->fd);
  delete s;
  g_shards[handle] = nullptr;
  return 0;
}

// Fill a (batch, seq_len) int32 buffer from per-row start offsets,
// multithreaded over rows. Offsets wrap at the shard end.
int skt_fill_windows(int64_t handle, const int64_t* starts, int64_t batch,
                     int64_t seq_len, int32_t* out) {
  Shard* s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (handle < 0 || handle >= static_cast<int64_t>(g_shards.size()) ||
        !g_shards[handle])
      return -1;
    s = g_shards[handle];
  }
  if (s->count == 0) return -2;
  parallel_rows(batch, [&](int64_t r) {
    widen_range(*s, static_cast<uint64_t>(starts[r] % s->count), seq_len,
                out + r * seq_len);
  });
  return 0;
}

// ---- background prefetcher -------------------------------------------------

struct Prefetcher {
  Shard* shard;
  int64_t batch, seq_len, stride;
  uint64_t next_start;
  size_t depth;
  std::vector<std::vector<int32_t>> ring;
  size_t head = 0, tail = 0, filled = 0;
  std::mutex mu;
  std::condition_variable cv_filler, cv_reader;
  std::thread worker;
  std::atomic<bool> stop{false};

  void fill_one(std::vector<int32_t>& buf) {
    for (int64_t r = 0; r < batch; ++r) {
      widen_range(*shard, next_start % shard->count, seq_len,
                  buf.data() + r * seq_len);
      next_start += static_cast<uint64_t>(stride);
    }
  }

  void run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_filler.wait(lk, [&] { return stop.load() || filled < depth; });
      if (stop.load()) return;
      auto& buf = ring[tail];
      lk.unlock();
      fill_one(buf);  // IO outside the lock
      lk.lock();
      tail = (tail + 1) % depth;
      ++filled;
      cv_reader.notify_one();
    }
  }
};

std::vector<Prefetcher*> g_prefetchers;

int64_t skt_prefetch_start(int64_t handle, int64_t batch, int64_t seq_len,
                           int64_t stride, int64_t start, int64_t depth) {
  Shard* s;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (handle < 0 || handle >= static_cast<int64_t>(g_shards.size()) ||
        !g_shards[handle])
      return -1;
    s = g_shards[handle];
  }
  if (s->count == 0 || batch <= 0 || seq_len <= 0 || depth <= 0) return -2;
  auto* p = new Prefetcher;
  p->shard = s;
  p->batch = batch;
  p->seq_len = seq_len;
  p->stride = stride > 0 ? stride : seq_len;
  p->next_start = static_cast<uint64_t>(start % static_cast<int64_t>(s->count));
  p->depth = static_cast<size_t>(depth);
  p->ring.assign(p->depth, std::vector<int32_t>(batch * seq_len));
  p->worker = std::thread([p] { p->run(); });
  std::lock_guard<std::mutex> lk(g_mu);
  g_prefetchers.push_back(p);
  return static_cast<int64_t>(g_prefetchers.size() - 1);
}

int skt_prefetch_next(int64_t pf, int32_t* out) {
  Prefetcher* p;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (pf < 0 || pf >= static_cast<int64_t>(g_prefetchers.size()) ||
        !g_prefetchers[pf])
      return -1;
    p = g_prefetchers[pf];
  }
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_reader.wait(lk, [&] { return p->filled > 0; });
  std::memcpy(out, p->ring[p->head].data(),
              sizeof(int32_t) * p->batch * p->seq_len);
  p->head = (p->head + 1) % p->depth;
  --p->filled;
  p->cv_filler.notify_one();
  return 0;
}

int skt_prefetch_stop(int64_t pf) {
  Prefetcher* p;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (pf < 0 || pf >= static_cast<int64_t>(g_prefetchers.size()) ||
        !g_prefetchers[pf])
      return -1;
    p = g_prefetchers[pf];
    g_prefetchers[pf] = nullptr;
  }
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
  }
  p->cv_filler.notify_all();
  p->worker.join();
  delete p;
  return 0;
}

}  // extern "C"

// The page cache of xgboost_tpu_torch's external-memory matrix
// (data/external.py PagedBins): the page file writer and a ring of
// prefetched pages. Reference analog: the disk-backed page source with its
// ring of in-flight reads (xgboost's sparse_page_source design: pages
// written to a cache file, a small window prefetched ahead of the training
// loop). Plain C ABI for ctypes, built with g++ at first use
// (xgboost_tpu_torch/native/__init__.py).
//
// Writer: one file per page (bit-packed bins).
// Reader: N slots of prefetched pages; a worker thread reads ahead in
// sequence order while the grower consumes the current page, so the disk
// read of the next page overlaps the copy to the card and the level
// kernels.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Reader {
  std::vector<std::string> paths;
  std::vector<long long> sizes;
  long long max_bytes = 0;
  int ring = 4;

  std::vector<std::vector<char>> slot_buf;
  std::vector<long long> slot_page;  // which page a slot holds (-1 empty)
  std::vector<bool> slot_ready;

  std::mutex mu;
  std::condition_variable cv;
  long long next_want = 0;  // prefetcher target (sequential)
  std::atomic<bool> stop{false};
  std::thread worker;

  int slot_of(long long k) const { return static_cast<int>(k % ring); }

  bool read_file(long long k, std::vector<char>* out) {
    FILE* f = std::fopen(paths[k].c_str(), "rb");
    if (!f) return false;
    out->resize(sizes[k]);
    size_t got = std::fread(out->data(), 1, sizes[k], f);
    std::fclose(f);
    return got == static_cast<size_t>(sizes[k]);
  }

  void run() {
    for (;;) {
      long long k;
      {
        std::unique_lock<std::mutex> lk(mu);
        // only advance into a FREE slot — never clobber a prefetched page
        // the consumer has not taken yet
        cv.wait(lk, [&] {
          if (stop.load()) return true;
          if (next_want >= static_cast<long long>(paths.size())) return false;
          return !slot_ready[slot_of(next_want)];
        });
        if (stop.load()) return;
        k = next_want;
        next_want++;
      }
      std::vector<char> buf;
      bool ok = read_file(k, &buf);
      {
        std::lock_guard<std::mutex> lk(mu);
        int s = slot_of(k);
        if (ok) {
          slot_buf[s] = std::move(buf);
          slot_page[s] = k;
          slot_ready[s] = true;
        }
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int pc_write(const char* path, const void* buf, long long nbytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  size_t put = std::fwrite(buf, 1, nbytes, f);
  std::fclose(f);
  return put == static_cast<size_t>(nbytes) ? 0 : 2;
}

void* pc_open(const char* prefix, long long n_pages,
              const long long* sizes, int ring) {
  auto* r = new Reader();
  r->ring = ring > 0 ? ring : 4;
  for (long long k = 0; k < n_pages; ++k) {
    r->paths.push_back(std::string(prefix) + ".page" + std::to_string(k) +
                       ".bin");
    r->sizes.push_back(sizes[k]);
    if (sizes[k] > r->max_bytes) r->max_bytes = sizes[k];
  }
  r->slot_buf.resize(r->ring);
  r->slot_page.assign(r->ring, -1);
  r->slot_ready.assign(r->ring, false);
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Blocking read of page k into dst; steers the prefetcher to k+1 onward.
// A miss (including the wrap-around at the start of each re-streaming
// sweep) resets the window: all slots are invalidated and the worker
// restarts at k+1.
int pc_read(void* h, long long k, void* dst) {
  auto* r = static_cast<Reader*>(h);
  if (k < 0 || k >= static_cast<long long>(r->paths.size())) return 1;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    int s = r->slot_of(k);
    if (r->slot_ready[s] && r->slot_page[s] == k) {
      std::memcpy(dst, r->slot_buf[s].data(), r->sizes[k]);
      r->slot_ready[s] = false;  // slot reusable
      if (r->next_want <= k) r->next_want = k + 1;
      r->cv.notify_all();
      return 0;
    }
    // miss: new sweep (or random access) — rewind the prefetch window
    for (int i = 0; i < r->ring; ++i) r->slot_ready[i] = false;
    r->next_want = k + 1;
  }
  r->cv.notify_all();
  std::vector<char> buf;
  if (!r->read_file(k, &buf)) return 2;
  std::memcpy(dst, buf.data(), r->sizes[k]);
  return 0;
}

void pc_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  r->stop.store(true);
  r->cv.notify_all();
  if (r->worker.joinable()) r->worker.join();
  delete r;
}

}  // extern "C"

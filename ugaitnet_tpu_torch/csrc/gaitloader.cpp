// Native host-side batch gather for ugaitnet_tpu_torch.
//
// The port's own copy of ugaitnet_tpu/native/gaitloader.cpp (same ABI,
// version 3).  The per-batch host work is a strided gather: copy N selected
// rows (one quantized clip volume each, ~90-360 KB) from a memory-mapped
// packed array into a contiguous staging buffer for the copy to the card.
// NumPy fancy indexing does this single-threaded and touch-faults mmap pages
// serially; this library does the row copies on a thread pool (the ctypes
// call releases the GIL), typically saturating memory bandwidth.
//
// Built with the host C++ compiler at first use by
// ugaitnet_tpu_torch/data/native.py into build/native/.
//
// Exposed C ABI:
//   ug_gather_rows(src, nrows, row_bytes, idx, n, out, nthreads) -> int
//     (0 = ok, 1 = an index was out of [0, nrows) - nothing copied)
//   ug_version()

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Persistent worker pool: spawning threads per batch (~50us each) would eat
// the win on small gathers, so workers park on a condition variable and the
// caller hands them a work function + item count.
class Pool {
 public:
  static Pool& instance() {
    // leaked on purpose: workers are detached, so neither they nor the
    // pool's sync primitives may be destroyed at process exit.
    static Pool* pool = new Pool();
    return *pool;
  }

  void run(int64_t items, int nthreads,
           const std::function<void(int64_t)>& fn) {
    if (items <= 0) return;
    if (std::thread::hardware_concurrency() <= 1) {
      for (int64_t i = 0; i < items; ++i) fn(i);  // no pool win on 1 core
      return;
    }
    // One dispatch at a time: ctypes releases the GIL, so two Python threads
    // (e.g. two live PrefetchLoaders) can enter run() concurrently; without
    // this they would race on fn_/items_/pending_/next_.
    std::lock_guard<std::mutex> dispatch_lock(run_m_);
    ensure_started();
    int usable = nslots_;
    if (nthreads > 0 && nthreads < usable) usable = nthreads;
    if (usable <= 1 || items == 1) {
      for (int64_t i = 0; i < items; ++i) fn(i);
      return;
    }
    {
      std::unique_lock<std::mutex> lock(m_);
      fn_ = &fn;
      next_.store(0, std::memory_order_relaxed);
      items_ = items;
      pending_ = usable;
      ++generation_;
      active_ = usable - 1;  // caller participates as the remaining slot
    }
    cv_.notify_all();
    // caller participates too
    work();
    std::unique_lock<std::mutex> lock(m_);
    done_cv_.wait(lock, [&] { return pending_ == 0; });
    fn_ = nullptr;
  }

 private:
  Pool() = default;

  void ensure_started() {
    std::call_once(started_, [&] {
      int n = (int)std::thread::hardware_concurrency();
      if (n < 2) n = 2;
      if (n > 32) n = 32;
      nslots_ = n;  // n-1 workers + the calling thread
      for (int t = 0; t < n - 1; ++t) {
        std::thread th([this] { worker_loop(); });
        th.detach();  // never joined; must not block process exit
      }
    });
  }

  void work() {
    const std::function<void(int64_t)>* fn = fn_;
    int64_t items = items_;
    for (;;) {
      int64_t i = next_.fetch_add(1, std::memory_order_relaxed);
      if (i >= items) break;
      (*fn)(i);
    }
    std::unique_lock<std::mutex> lock(m_);
    if (--pending_ == 0) done_cv_.notify_all();
  }

  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lock(m_);
        cv_.wait(lock, [&] { return generation_ != seen && fn_; });
        seen = generation_;
        if (active_ <= 0) continue;
        --active_;
      }
      work();
    }
  }

  std::once_flag started_;
  int nslots_ = 1;
  std::mutex run_m_;  // serializes concurrent run() callers
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int64_t)>* fn_ = nullptr;
  std::atomic<int64_t> next_{0};
  int64_t items_ = 0;
  int pending_ = 0;
  int active_ = 0;
  uint64_t generation_ = 0;
};

}  // namespace

extern "C" {

int ug_version() { return 3; }

// Copy rows idx[0..n) of src (row_bytes each) into out contiguously.
// Indices are validated up front (an OOB index would otherwise be a
// silent out-of-bounds memcpy where the numpy fallback raises); returns
// 1 without copying anything if any index is outside [0, nrows).
int ug_gather_rows(const uint8_t* src, int64_t nrows, int64_t row_bytes,
                   const int64_t* idx, int64_t n, uint8_t* out,
                   int nthreads) {
  for (int64_t i = 0; i < n; ++i) {
    if (idx[i] < 0 || idx[i] >= nrows) return 1;
  }
  Pool::instance().run(n, nthreads, [&](int64_t i) {
    std::memcpy(out + i * row_bytes, src + idx[i] * row_bytes,
                (size_t)row_bytes);
  });
  return 0;
}

}  // extern "C"

// The host half of the frame upload (core/device.py upload): copy a host
// array of any strides into a contiguous (pinned) buffer in C order.  Plain
// C++ with no library, built by the kernels' single nvcc call
// (ops/_build.py) and called through ctypes, which releases the GIL.
//
// One core's copy runs at a few GB/s, so the work is shared: the array is
// cut into items of kItemBytes, claimed from one counter by the caller and
// by up to `helpers` threads of a pool that lives as long as the process.
// The caller wakes the helpers and starts at once; it claims items until
// none is left, then waits only for the items a helper has claimed.  A
// helper that wakes late finds nothing left and holds no one up, so the
// call never waits on a sleeping core to be scheduled.  Several callers may
// copy at once: each one finishes its own array, and the helpers join the
// newest.
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxDims = 16;
constexpr int64_t kItemBytes = 256 << 10;

struct Job {
  char* dst;
  const char* src;
  int ndim;               // after merging, >= 1; the last dim is the inner run
  int64_t shape[kMaxDims];
  int64_t stride[kMaxDims];  // in bytes, any sign
  int64_t elem;           // bytes of one element
  int64_t numel;
  int64_t per_item;       // elements an item
  int64_t items;
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> done{0};
  std::atomic<int> seats{0};  // helpers that may still join
};

// Elements [e0, e1) of the C-order walk of the source into dst.
void copy_range(const Job& j, int64_t e0, int64_t e1) {
  const int last = j.ndim - 1;
  const int64_t n_in = j.shape[last], s_in = j.stride[last], elem = j.elem;
  int64_t e = e0;
  while (e < e1) {
    int64_t row = e / n_in, k = e % n_in;
    const int64_t run = std::min(n_in - k, e1 - e);
    int64_t off = k * s_in;
    for (int d = last - 1; d >= 0; --d) {
      off += (row % j.shape[d]) * j.stride[d];
      row /= j.shape[d];
    }
    const char* s = j.src + off;
    char* o = j.dst + e * elem;
    if (s_in == elem) {
      std::memcpy(o, s, static_cast<size_t>(run * elem));
    } else if (elem == 1) {
      for (int64_t i = 0; i < run; ++i) o[i] = s[i * s_in];
    } else {
      for (int64_t i = 0; i < run; ++i) std::memcpy(o + i * elem, s + i * s_in, elem);
    }
    e += run;
  }
}

void work(Job& j) {
  for (;;) {
    const int64_t i = j.next.fetch_add(1, std::memory_order_relaxed);
    if (i >= j.items) return;
    copy_range(j, i * j.per_item, std::min((i + 1) * j.per_item, j.numel));
    j.done.fetch_add(1, std::memory_order_release);
  }
}

class Pool {
 public:
  // Grows the pool to at least n threads (never shrinks).
  void reserve(int n) {
    std::lock_guard<std::mutex> g(m_);
    while (threads_ < n) {
      std::thread(&Pool::loop, this).detach();
      ++threads_;
    }
  }

  void post(std::shared_ptr<Job> job) {
    {
      std::lock_guard<std::mutex> g(m_);
      job_ = std::move(job);
      ++generation_;
    }
    cv_.notify_all();
  }

 private:
  void loop() {
    uint64_t seen = 0;
    for (;;) {
      std::shared_ptr<Job> job;
      {
        std::unique_lock<std::mutex> l(m_);
        cv_.wait(l, [&] { return generation_ != seen; });
        seen = generation_;
        job = job_;
      }
      if (job->seats.fetch_sub(1, std::memory_order_relaxed) > 0) work(*job);
    }
  }

  std::mutex m_;
  std::condition_variable cv_;
  std::shared_ptr<Job> job_;
  uint64_t generation_ = 0;
  int threads_ = 0;
};

Pool& pool() {
  static Pool* p = new Pool();  // never destroyed: detached threads wait on it
  return *p;
}

}  // namespace

// Copy the ndim-dimensional array at src (shape, strides in bytes, elem
// bytes an element) into dst in C order, with the caller and up to helpers
// threads of the pool.  Returns 0, or 1 for more than kMaxDims dims or a
// negative size.
extern "C" int ofc_host_gather(void* dst, const void* src, int ndim,
                               const int64_t* shape, const int64_t* strides,
                               int64_t elem, int helpers) {
  if (ndim < 0 || ndim > kMaxDims || elem <= 0) return 1;
  auto job = std::make_shared<Job>();
  job->dst = static_cast<char*>(dst);
  job->src = static_cast<const char*>(src);
  job->elem = elem;
  job->numel = 1;
  // merge each dim into the one inside it where the strides allow, drop
  // dims of size 1: a contiguous array becomes one run of numel elements
  int n = 0;
  for (int d = 0; d < ndim; ++d) {
    if (shape[d] < 0) return 1;
    job->numel *= shape[d];
    if (shape[d] == 1) continue;
    if (n > 0 && job->stride[n - 1] == strides[d] * shape[d]) {
      job->shape[n - 1] *= shape[d];
      job->stride[n - 1] = strides[d];
    } else {
      job->shape[n] = shape[d];
      job->stride[n] = strides[d];
      ++n;
    }
  }
  if (job->numel == 0) return 0;
  if (n == 0) {  // one element
    job->shape[0] = 1;
    job->stride[0] = elem;
    n = 1;
  }
  job->ndim = n;
  job->per_item = std::max<int64_t>(kItemBytes / elem, 1);
  job->items = (job->numel + job->per_item - 1) / job->per_item;
  helpers = static_cast<int>(std::min<int64_t>(std::max(helpers, 0), job->items - 1));
  if (helpers > 0) {
    job->seats.store(helpers, std::memory_order_relaxed);
    pool().reserve(helpers);
    pool().post(job);
  }
  work(*job);
  while (job->done.load(std::memory_order_acquire) < job->items) std::this_thread::yield();
  return 0;
}

// Threaded file I/O for tensor swapping (ZeRO-Infinity).
//
// The port's copy of the JAX package's csrc/aio/deepspeed_aio.cpp, code
// unchanged: an `aio_handle` owning a pool of I/O threads; reads and writes
// are chunked to `block_size`, fanned out across the pool, and completed
// synchronously or asynchronously with an explicit wait().
//
// Files are opened without O_DIRECT (aio_async_pread / aio_async_pwrite
// below): every read and write goes through the page cache. The JAX copy's
// header says O_DIRECT is tried first; its code does not.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <memory>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

struct IoTask {
    std::function<int()> fn;
};

class ThreadPool {
  public:
    explicit ThreadPool(int num_threads) : stop_(false), pending_(0), errors_(0) {
        for (int i = 0; i < num_threads; ++i) {
            workers_.emplace_back([this] { this->loop(); });
        }
    }

    ~ThreadPool() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& w : workers_) w.join();
    }

    void submit(std::function<int()> fn) {
        {
            std::unique_lock<std::mutex> lk(mu_);
            tasks_.push_back(IoTask{std::move(fn)});
            ++pending_;
        }
        cv_.notify_one();
    }

    // Block until every submitted task has completed; returns the number of
    // failed tasks since the last wait.
    int wait() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return pending_ == 0; });
        int e = errors_;
        errors_ = 0;
        return e;
    }

  private:
    void loop() {
        for (;;) {
            IoTask task;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
                if (stop_ && tasks_.empty()) return;
                task = std::move(tasks_.front());
                tasks_.pop_front();
            }
            int rc = task.fn();
            // Release the task's closure BEFORE decrementing pending_: the last
            // chunk's lambda holds the final FdGuard reference, and its
            // fsync/close must complete (and record any error) before wait()
            // can observe pending_ == 0.
            task.fn = nullptr;
            {
                std::unique_lock<std::mutex> lk(mu_);
                if (rc != 0) ++errors_;
                if (--pending_ == 0) done_cv_.notify_all();
            }
        }
    }

    std::vector<std::thread> workers_;
    std::deque<IoTask> tasks_;
    std::mutex mu_;
    std::condition_variable cv_;
    std::condition_variable done_cv_;
    bool stop_;
    int pending_;
    int errors_;
};

int full_pread(int fd, char* buf, int64_t nbytes, int64_t offset) {
    int64_t done = 0;
    while (done < nbytes) {
        ssize_t r = ::pread(fd, buf + done, nbytes - done, offset + done);
        if (r < 0) return -1;
        if (r == 0) return -2;  // unexpected EOF
        done += r;
    }
    return 0;
}

int full_pwrite(int fd, const char* buf, int64_t nbytes, int64_t offset) {
    int64_t done = 0;
    while (done < nbytes) {
        ssize_t w = ::pwrite(fd, buf + done, nbytes - done, offset + done);
        if (w < 0) return -1;
        done += w;
    }
    return 0;
}

struct AioHandle {
    int64_t block_size;
    int queue_depth;  // chunks in flight per op (informational: pool-wide fanout)
    bool single_submit;
    bool overlap_events;
    std::atomic<int> close_errors{0};
    ThreadPool pool;

    AioHandle(int64_t bs, int qd, bool ss, bool oe, int threads)
        : block_size(bs), queue_depth(qd), single_submit(ss), overlap_events(oe), pool(threads) {}
};

// Closes (and for writes, fsyncs) the fd when the LAST chunk task drops its
// reference — every chunk lambda holds a shared_ptr, so the fd provably
// outlives all in-flight I/O on it.
struct FdGuard {
    int fd;
    bool write;
    AioHandle* handle;
    FdGuard(int fd_, bool write_, AioHandle* handle_) : fd(fd_), write(write_), handle(handle_) {}
    FdGuard(const FdGuard&) = delete;  // one owner: a copy's destructor would double-close
    FdGuard& operator=(const FdGuard&) = delete;
    ~FdGuard() {
        int rc = 0;
        if (write && ::fsync(fd) != 0) rc = -1;
        if (::close(fd) != 0) rc = -1;
        if (rc != 0) handle->close_errors.fetch_add(1);
    }
};

// Chunk [0, nbytes) into block_size pieces and fan them across the pool.
void submit_chunked(AioHandle* h, std::shared_ptr<FdGuard> guard, char* buf, int64_t nbytes,
                    bool write) {
    int64_t bs = h->single_submit ? nbytes : h->block_size;
    for (int64_t off = 0; off < nbytes; off += bs) {
        int64_t len = std::min(bs, nbytes - off);
        if (write) {
            h->pool.submit(
                [guard, buf, len, off] { return full_pwrite(guard->fd, buf + off, len, off); });
        } else {
            h->pool.submit(
                [guard, buf, len, off] { return full_pread(guard->fd, buf + off, len, off); });
        }
    }
}

}  // namespace

extern "C" {

// --- handle lifecycle (reference aio_handle class) -----------------------
void* aio_handle_create(int64_t block_size, int queue_depth, int single_submit,
                        int overlap_events, int num_threads) {
    if (block_size <= 0) block_size = 1 << 20;  // reference default: 1MB
    if (num_threads <= 0) num_threads = 1;      // reference default: 1
    return new AioHandle(block_size, queue_depth, single_submit != 0, overlap_events != 0,
                         num_threads);
}

void aio_handle_destroy(void* handle) { delete static_cast<AioHandle*>(handle); }

int64_t aio_block_size(void* handle) { return static_cast<AioHandle*>(handle)->block_size; }
int aio_queue_depth(void* handle) { return static_cast<AioHandle*>(handle)->queue_depth; }

// --- async submit + wait (reference async_pread/async_pwrite + wait) -----
// Caller owns `buf` until wait() returns. Returns 0 on successful submit.
int aio_async_pread(void* handle, void* buf, const char* filename, int64_t nbytes) {
    auto* h = static_cast<AioHandle*>(handle);
    int fd = ::open(filename, O_RDONLY);
    if (fd < 0) return -1;
    auto guard = std::make_shared<FdGuard>(fd, /*write=*/false, h);
    submit_chunked(h, guard, static_cast<char*>(buf), nbytes, /*write=*/false);
    return 0;
}

int aio_async_pwrite(void* handle, const void* buf, const char* filename, int64_t nbytes) {
    auto* h = static_cast<AioHandle*>(handle);
    int fd = ::open(filename, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return -1;
    if (::ftruncate(fd, nbytes) != 0) {
        ::close(fd);
        return -1;
    }
    auto guard = std::make_shared<FdGuard>(fd, /*write=*/true, h);
    submit_chunked(h, guard, const_cast<char*>(static_cast<const char*>(buf)), nbytes,
                   /*write=*/true);
    return 0;
}

// Block until all submitted ops complete; returns count of failed ops
// (chunk I/O failures + fsync/close failures).
int aio_wait(void* handle) {
    auto* h = static_cast<AioHandle*>(handle);
    int errs = h->pool.wait();
    errs += h->close_errors.exchange(0);
    return errs;
}

// --- synchronous helpers (reference sync_pread/sync_pwrite + module-level
// aio_read/aio_write, py_ds_aio.cpp:14-15) --------------------------------
int aio_sync_pread(void* handle, void* buf, const char* filename, int64_t nbytes) {
    if (aio_async_pread(handle, buf, filename, nbytes) != 0) return -1;
    return aio_wait(handle);
}

int aio_sync_pwrite(void* handle, const void* buf, const char* filename, int64_t nbytes) {
    if (aio_async_pwrite(handle, buf, filename, nbytes) != 0) return -1;
    return aio_wait(handle);
}

int64_t aio_file_size(const char* filename) {
    struct stat st;
    if (::stat(filename, &st) != 0) return -1;
    return static_cast<int64_t>(st.st_size);
}

// memcpy helper mirroring the reference's deepspeed_memcpy (py_ds_aio.cpp:16)
void deepspeed_memcpy(void* dst, const void* src, int64_t nbytes) {
    std::memcpy(dst, src, static_cast<size_t>(nbytes));
}

}  // extern "C"

// GPU resource adaptor: per-task memory-pressure scheduler.
//
// Re-implements the semantics of the reference SparkResourceAdaptor
// (spark-rapids-jni SparkResourceAdaptorJni.cpp — state machine described in
// SURVEY.md §2.2/§3.1) around a logical device-memory arena instead of an
// RMM resource chain: threads register for tasks, allocations draw from a
// byte budget, and exhaustion drives a cooperative retry/block/split
// protocol:
//
//   * a failed allocation BLOCKs the thread until a peer frees memory;
//   * if every task is blocked (deadlock), the lowest-priority thread is
//     told to roll back (RETRY_OOM -> caller frees its buffers, makes them
//     spillable, waits "until further notice" = BUFN);
//   * if every task is BUFN (no one can make progress), the
//     highest-priority thread is told to split its input and retry
//     (SPLIT_AND_RETRY_OOM) — guaranteed forward progress;
//   * frees wake the highest-priority BLOCKED thread (or rescue a BUFN
//     thread when none are BLOCKED).
//
// The host side (Python facade) turns returned codes into exceptions,
// mirroring the Java GpuRetryOOM/GpuSplitAndRetryOOM family.  A registered
// callback lets the host report threads that are blocked outside this
// allocator (the ThreadStateRegistry.isThreadBlocked equivalent), so the
// deadlock scan sees host-side waits too.
//
// Everything is plain C++17 + pthreads; exported as a C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

enum class State : int {
  UNKNOWN = 0,
  RUNNING = 1,
  ALLOC = 2,
  ALLOC_FREE = 3,
  BLOCKED = 4,
  BUFN_THROW = 5,
  BUFN_WAIT = 6,
  BUFN = 7,
  SPLIT_THROW = 8,
  REMOVE_THROW = 9,
};

enum Code : int {
  OK = 0,
  RETRY_OOM = 1,
  SPLIT_AND_RETRY_OOM = 2,
  OOM = 3,
  INJECTED_EXCEPTION = 4,
  UNKNOWN_THREAD = 5,
};

constexpr int MAX_RETRIES = 500;  // livelock bound (reference :984-992)

struct Injection {
  int remaining = 0;   // fire this many times...
  int skip = 0;        // ...after skipping this many allocations
};

struct ThreadInfo {
  long thread_id = 0;
  State state = State::RUNNING;
  bool is_shuffle = false;
  bool is_pool = false;
  std::set<long> tasks;          // empty for idle pool threads
  Injection inject_retry;
  Injection inject_split;
  Injection inject_exception;
  int retry_count = 0;           // consecutive failed allocs (watchdog)
  int blocked_pool = 0;          // which pool the thread last blocked on
  std::condition_variable cv;
  Clock::time_point blocked_since{};
  // start of the current FAILURE STREAK, cleared only by an alloc
  // success.  blocked_since resets on every wake->fail->re-block cycle,
  // so a churning peer (tiny alloc/free loop) would keep a starved
  // thread's continuous-block clock near zero forever; the stall breaker
  // keys off this instead.
  Clock::time_point stall_since{};

  long priority() const {
    // higher value = higher priority; shuffle outranks everything, then the
    // oldest (lowest-id) task wins
    if (is_shuffle) return INT64_MAX;
    long lowest = INT64_MAX - 1;
    for (long t : tasks) lowest = std::min(lowest, t);
    return INT64_MAX - 1 - lowest;
  }
};

struct TaskMetrics {
  long num_retry = 0;
  long num_split_retry = 0;
  long block_time_ns = 0;
  long lost_compute_time_ns = 0;
  long max_memory_allocated = 0;
  long cur_memory_allocated = 0;
};

// Pool indices: one adaptor schedules BOTH memory arenas through ONE
// thread state machine, so the deadlock scan sees a thread blocked on
// host memory while holding device budget (the reference handles mixed
// GPU+CPU blocking in one state machine too —
// SparkResourceAdaptorJni.cpp:808-842, RmmSparkTest mixed matrix).
constexpr int POOL_DEVICE = 0;
constexpr int POOL_HOST = 1;
constexpr int NUM_POOLS = 2;

class ResourceAdaptor {
 public:
  ResourceAdaptor(long pool_bytes, const char* log_path) {
    pool_bytes_[POOL_DEVICE] = pool_bytes;
    free_bytes_[POOL_DEVICE] = pool_bytes;
    pool_bytes_[POOL_HOST] = 0;   // disabled until set_host_pool
    free_bytes_[POOL_HOST] = 0;
    if (log_path && log_path[0]) log_ = std::fopen(log_path, "w");
    if (log_) std::fprintf(log_, "time_ns,op,thread,task,from,to,notes\n");
  }

  void set_host_pool(long bytes) {
    std::lock_guard<std::mutex> g(mu_);
    long delta = bytes - pool_bytes_[POOL_HOST];
    pool_bytes_[POOL_HOST] = bytes;
    free_bytes_[POOL_HOST] += delta;
    if (delta > 0)  // growth can unblock a host-starved thread
      wake_next_highest_priority_blocked(/*from_free=*/true, POOL_HOST);
  }

  ~ResourceAdaptor() {
    if (log_) std::fclose(log_);
  }

  using BlockedCb = int (*)(long);
  void set_blocked_callback(BlockedCb cb) { blocked_cb_ = cb; }

  // ---- thread/task registry ------------------------------------------
  void start_dedicated_task_thread(long tid, long task_id) {
    std::lock_guard<std::mutex> g(mu_);
    auto& t = threads_[tid];
    t.thread_id = tid;
    t.is_pool = false;
    t.tasks.insert(task_id);
    if (t.state == State::UNKNOWN) t.state = State::RUNNING;
    task_threads_[task_id].insert(tid);
    log_op("start_dedicated", tid, task_id, t.state, t.state, "");
  }

  void pool_thread_working_on_tasks(bool shuffle, long tid,
                                    const long* task_ids, int n) {
    std::lock_guard<std::mutex> g(mu_);
    auto& t = threads_[tid];
    t.thread_id = tid;
    t.is_pool = true;
    t.is_shuffle = shuffle;
    if (t.state == State::UNKNOWN) t.state = State::RUNNING;
    for (int i = 0; i < n; i++) {
      t.tasks.insert(task_ids[i]);
      task_threads_[task_ids[i]].insert(tid);
    }
  }

  void pool_thread_finished_for_tasks(long tid, const long* task_ids, int n) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = threads_.find(tid);
    if (it == threads_.end()) return;
    for (int i = 0; i < n; i++) {
      it->second.tasks.erase(task_ids[i]);
      auto tt = task_threads_.find(task_ids[i]);
      if (tt != task_threads_.end()) tt->second.erase(tid);
    }
    wake_next_highest_priority_blocked(/*from_free=*/true);
  }

  void remove_thread_association(long tid, long task_id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = threads_.find(tid);
    if (it == threads_.end()) return;
    if (task_id < 0) {
      for (long t : it->second.tasks) {
        auto tt = task_threads_.find(t);
        if (tt != task_threads_.end()) tt->second.erase(tid);
      }
      it->second.tasks.clear();
    } else {
      it->second.tasks.erase(task_id);
      auto tt = task_threads_.find(task_id);
      if (tt != task_threads_.end()) tt->second.erase(tid);
    }
    if (it->second.tasks.empty()) release_thread_locked(it);
    wake_next_highest_priority_blocked(/*from_free=*/true);
    // the released thread may have been the only runner keeping the
    // remaining (all-blocked) set out of deadlock: re-scan now instead
    // of waiting a watchdog period
    check_and_update_for_bufn_locked();
  }

  void task_done(long task_id) {
    std::lock_guard<std::mutex> g(mu_);
    auto tt = task_threads_.find(task_id);
    if (tt != task_threads_.end()) {
      for (long tid : std::set<long>(tt->second)) {
        auto it = threads_.find(tid);
        if (it == threads_.end()) continue;
        it->second.tasks.erase(task_id);
        if (it->second.tasks.empty()) release_thread_locked(it);
      }
      task_threads_.erase(tt);
    }
    wake_next_highest_priority_blocked(/*from_free=*/true);
    check_and_update_for_bufn_locked();
  }

  // ---- injection ------------------------------------------------------
  void force_retry_oom(long tid, int count, int skip) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = threads_.find(tid);
    if (it != threads_.end()) it->second.inject_retry = {count, skip};
  }
  void force_split_retry_oom(long tid, int count, int skip) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = threads_.find(tid);
    if (it != threads_.end()) it->second.inject_split = {count, skip};
  }
  void force_exception(long tid, int count, int skip) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = threads_.find(tid);
    if (it != threads_.end()) it->second.inject_exception = {count, skip};
  }

  // ---- the allocation protocol ---------------------------------------
  int allocate(long tid, long bytes, long* out_allocated,
               int pool = POOL_DEVICE) {
    for (;;) {
      int code = pre_alloc(tid);
      if (code != OK) return code;
      {
        std::unique_lock<std::mutex> lk(mu_);
        auto it = threads_.find(tid);
        if (it == threads_.end()) return UNKNOWN_THREAD;
        if (bytes <= free_bytes_[pool]) {
          free_bytes_[pool] -= bytes;
          allocated_[pool] += bytes;
          max_allocated_[pool] =
              std::max(max_allocated_[pool], allocated_[pool]);
          if (pool == POOL_DEVICE) {  // task metrics track device memory
            for (long task : it->second.tasks) {
              auto& m = metrics_[task];
              m.cur_memory_allocated += bytes;
              m.max_memory_allocated =
                  std::max(m.max_memory_allocated, m.cur_memory_allocated);
            }
          }
          post_alloc_success_locked(it->second);
          if (out_allocated) *out_allocated = allocated_[pool];
          return OK;
        }
        bool retry = post_alloc_failed_locked(it->second, bytes, pool);
        if (!retry) return OOM;
      }
    }
  }

  // A REAL device allocation failed (torch.OutOfMemoryError from the CUDA
  // caching allocator) outside the logical arena.  Drive the same failure
  // protocol as a logical alloc failure — park while the scheduler holds us
  // back, BUFN-escalate, honor SPLIT_THROW — then tell the caller to retry
  // the step.  The
  // reference interposes the real allocator so its failure path IS this
  // path (SparkResourceAdaptorJni.cpp:1731-1798); here PyTorch's caching
  // allocator owns physical buffers, so the failure arrives after the fact
  // and the protocol runs where the error surfaces instead.
  int device_alloc_failed(long tid) {
    int code = pre_alloc(tid);  // surfaces pending escalations/injections
    if (code != OK) return code;
    {
      std::unique_lock<std::mutex> lk(mu_);
      auto it = threads_.find(tid);
      if (it == threads_.end()) return UNKNOWN_THREAD;
      bool retry = post_alloc_failed_locked(it->second, 0, POOL_DEVICE);
      if (!retry) return OOM;  // retry cap: the 500-retry livelock bound
    }
    // parks while BLOCKED/BUFN; converts BUFN_THROW/SPLIT_THROW to codes
    code = pre_alloc(tid);
    if (code != OK) return code;
    {
      std::unique_lock<std::mutex> lk(mu_);
      auto it = threads_.find(tid);
      if (it == threads_.end()) return UNKNOWN_THREAD;
      ThreadInfo& t = it->second;
      // block time was already accounted by whichever wake path released
      // us (wake_next_highest_priority_blocked / BUFN paths); adding it
      // again here would double-count the same blocked_since interval
      bump_metric(t, &TaskMetrics::num_retry);
      set_state(t, State::RUNNING, "device_oom_retry");
    }
    return RETRY_OOM;  // peers freed memory: re-run the step now
  }

  // The caller's step completed after a retry ladder: the failure streak
  // is over, so the 500-retry livelock bound starts fresh.  (A logical
  // allocate() success resets the counter in post_alloc_success_locked;
  // real-device-OOM recoveries never pass through allocate, so they
  // signal here instead — otherwise retry_count would be monotonic over
  // the thread's lifetime and eventually hard-OOM a healthy thread.)
  void alloc_recovered(long tid) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = threads_.find(tid);
    if (it != threads_.end()) it->second.retry_count = 0;
  }

  // Re-size the logical pool to track what the device reports
  // (torch.cuda.mem_get_info and the caching allocator's counters); growing
  // frees budget, shrinking can drive free_bytes_ negative, which simply
  // blocks new allocations until enough is released.
  void resize_pool(long new_pool_bytes, int pool = POOL_DEVICE) {
    std::lock_guard<std::mutex> g(mu_);
    long delta = new_pool_bytes - pool_bytes_[pool];
    pool_bytes_[pool] = new_pool_bytes;
    free_bytes_[pool] += delta;
    if (delta > 0)
      wake_next_highest_priority_blocked(/*from_free=*/true, pool);
  }

  void deallocate(long tid, long bytes, int pool = POOL_DEVICE) {
    std::lock_guard<std::mutex> g(mu_);
    free_bytes_[pool] = std::min(free_bytes_[pool] + bytes,
                                 pool_bytes_[pool]);
    allocated_[pool] = std::max<long>(0, allocated_[pool] - bytes);
    auto it = threads_.find(tid);
    if (pool == POOL_DEVICE && it != threads_.end()) {
      for (long task : it->second.tasks) {
        auto& m = metrics_[task];
        m.cur_memory_allocated = std::max<long>(0, m.cur_memory_allocated - bytes);
      }
    }
    // a free may let a blocked peer proceed; threads mid-ALLOC get marked so
    // a failure retries immediately instead of blocking on stale info
    for (auto& [id, t] : threads_) {
      if (t.state == State::ALLOC) set_state(t, State::ALLOC_FREE, "peer_free");
    }
    wake_next_highest_priority_blocked(/*from_free=*/true, pool);
  }

  // after catching a retry/split OOM the caller parks here until the
  // scheduler says the thread may proceed (RmmSpark.blockThreadUntilReady)
  int block_thread_until_ready(long tid) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = threads_.find(tid);
    if (it == threads_.end()) return UNKNOWN_THREAD;
    ThreadInfo& t = it->second;
    if (t.state == State::REMOVE_THROW) {  // task released before the park
      threads_.erase(it);
      return UNKNOWN_THREAD;
    }
    if (t.state == State::BUFN_WAIT) {
      set_state(t, State::BUFN, "bufn_wait");
      t.blocked_since = Clock::now();
      check_and_update_for_bufn_locked();
      while (t.state == State::BUFN) t.cv.wait(lk);
      add_block_time(t);
      if (t.state == State::REMOVE_THROW) {  // task released mid-park
        threads_.erase(it);
        return UNKNOWN_THREAD;
      }
      if (t.state == State::BUFN_THROW) {  // re-escalated while waiting
        set_state(t, State::BUFN_WAIT, "rethrow");
        return RETRY_OOM;
      }
      if (t.state == State::SPLIT_THROW) {
        set_state(t, State::RUNNING, "split");
        bump_metric(t, &TaskMetrics::num_split_retry);
        return SPLIT_AND_RETRY_OOM;
      }
    }
    return OK;
  }

  int get_state_of(long tid) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = threads_.find(tid);
    return it == threads_.end() ? 0 : static_cast<int>(it->second.state);
  }

  int check_and_break_deadlocks() {
    std::lock_guard<std::mutex> g(mu_);
    return check_and_update_for_bufn_locked() ? 1 : 0;
  }

  long get_and_reset_metric(long task_id, int which) {
    std::lock_guard<std::mutex> g(mu_);
    auto& m = metrics_[task_id];
    long* p = nullptr;
    switch (which) {
      case 0: p = &m.num_retry; break;
      case 1: p = &m.num_split_retry; break;
      case 2: p = &m.block_time_ns; break;
      case 3: p = &m.lost_compute_time_ns; break;
      case 4: p = &m.max_memory_allocated; break;
      default: return -1;
    }
    long v = *p;
    if (which != 4) *p = 0;  // max-memory is read-only here
    return v;
  }

  long total_allocated(int pool = POOL_DEVICE) {
    std::lock_guard<std::mutex> g(mu_);
    return allocated_[pool];
  }
  long max_allocated(int pool = POOL_DEVICE) {
    std::lock_guard<std::mutex> g(mu_);
    return max_allocated_[pool];
  }

  // Serving-mode deadlock breaker: the global scan above only acts when
  // EVERY task thread is blocked, so a BUFN/BLOCKED cycle among a subset
  // of tenants starves indefinitely behind any tenant that keeps running.
  // Treat threads continuously blocked past stall_ms as that smaller
  // deadlock: roll back the lowest-priority stalled BLOCKED thread, or —
  // when every stalled thread is already BUFN — split the
  // highest-priority one.  A false positive (the thread would have been
  // woken eventually) is benign: RETRY_OOM re-enters the retry ladder.
  int break_stalled_cycles(long stall_ms) {
    std::lock_guard<std::mutex> g(mu_);
    auto now = Clock::now();
    auto stalled = [&](const ThreadInfo& t) {
      if (t.stall_since == Clock::time_point{}) return false;
      return std::chrono::duration_cast<std::chrono::milliseconds>(
                 now - t.stall_since)
                 .count() >= stall_ms;
    };
    ThreadInfo* victim = nullptr;
    for (auto& [id, t] : threads_) {
      if (t.state != State::BLOCKED || t.tasks.empty() || !stalled(t))
        continue;
      if (!victim || t.priority() < victim->priority()) victim = &t;
    }
    if (victim) {
      bump_metric(*victim, &TaskMetrics::num_retry);
      set_state(*victim, State::BUFN_THROW, "stall_break");
      victim->cv.notify_all();
      return 1;
    }
    ThreadInfo* chosen = nullptr;
    for (auto& [id, t] : threads_) {
      if (t.state != State::BUFN || t.tasks.empty() || !stalled(t)) continue;
      if (!chosen || t.priority() > chosen->priority()) chosen = &t;
    }
    if (chosen) {
      set_state(*chosen, State::SPLIT_THROW, "stall_split");
      chosen->cv.notify_all();
      return 1;
    }
    return 0;
  }

 private:
  // ---- state helpers (mu_ held) --------------------------------------
  // A thread whose LAST task was released while it is parked (or between
  // a throw and its park) cannot simply be erased: destroying the cv
  // under a live waiter is UB, and the waiter would otherwise sleep
  // until the 10s watchdog join timeout.  Wake it with REMOVE_THROW so
  // it fails out of pre_alloc / block_thread_until_ready with
  // UNKNOWN_THREAD and erases itself.  Threads not parked are erased
  // (dedicated) or kept idle (pool) exactly as before.
  void release_thread_locked(std::map<long, ThreadInfo>::iterator it) {
    ThreadInfo& t = it->second;
    switch (t.state) {
      case State::BLOCKED:
      case State::BUFN:
      case State::BUFN_THROW:
      case State::BUFN_WAIT:
      case State::SPLIT_THROW:
        set_state(t, State::REMOVE_THROW, "task_released");
        t.cv.notify_all();
        return;
      case State::REMOVE_THROW:
        // already failed out (or never re-entered): safe to drop now
        threads_.erase(it);
        return;
      default:
        break;
    }
    if (!t.is_pool) threads_.erase(it);
  }

  void set_state(ThreadInfo& t, State s, const char* why) {
    log_op("transition", t.thread_id, -1, t.state, s, why);
    t.state = s;
  }

  void log_op(const char* op, long tid, long task, State from, State to,
              const char* notes) {
    if (!log_) return;
    auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                  Clock::now().time_since_epoch())
                  .count();
    std::fprintf(log_, "%lld,%s,%ld,%ld,%d,%d,%s\n",
                 static_cast<long long>(ns), op, tid, task,
                 static_cast<int>(from), static_cast<int>(to), notes);
  }

  void bump_metric(ThreadInfo& t, long TaskMetrics::*field) {
    for (long task : t.tasks) metrics_[task].*field += 1;
  }

  void add_block_time(ThreadInfo& t) {
    auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                  Clock::now() - t.blocked_since)
                  .count();
    for (long task : t.tasks) metrics_[task].block_time_ns += ns;
  }

  static bool consume(Injection& inj) {
    if (inj.remaining <= 0) return false;
    if (inj.skip > 0) {
      inj.skip--;
      return false;
    }
    inj.remaining--;
    return true;
  }

  // returns OK to proceed with the allocation, or a throw code
  int pre_alloc(long tid) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = threads_.find(tid);
    if (it == threads_.end()) return UNKNOWN_THREAD;
    ThreadInfo& t = it->second;

    if (consume(t.inject_exception)) return INJECTED_EXCEPTION;
    if (consume(t.inject_split)) {
      bump_metric(t, &TaskMetrics::num_split_retry);
      return SPLIT_AND_RETRY_OOM;
    }
    if (consume(t.inject_retry)) {
      // injected OOMs throw without a state transition (the reference's
      // pre_alloc injections leave the thread RUNNING, :1265-1304) so a
      // following block_thread_until_ready returns immediately
      bump_metric(t, &TaskMetrics::num_retry);
      log_op("injected_retry", t.thread_id, -1, t.state, t.state, "");
      return RETRY_OOM;
    }

    // wait while the scheduler holds us back
    while (t.state == State::BLOCKED || t.state == State::BUFN) {
      t.cv.wait(lk);
    }
    switch (t.state) {
      case State::BUFN_THROW:
        set_state(t, State::BUFN_WAIT, "bufn_throw");
        bump_metric(t, &TaskMetrics::num_retry);
        add_block_time(t);
        return RETRY_OOM;
      case State::SPLIT_THROW:
        set_state(t, State::RUNNING, "split_throw");
        bump_metric(t, &TaskMetrics::num_split_retry);
        add_block_time(t);
        return SPLIT_AND_RETRY_OOM;
      case State::REMOVE_THROW:
        threads_.erase(it);
        return UNKNOWN_THREAD;
      default:
        break;
    }
    set_state(t, State::ALLOC, "pre_alloc");
    return OK;
  }

  void post_alloc_success_locked(ThreadInfo& t) {
    set_state(t, State::RUNNING, "alloc_ok");
    t.retry_count = 0;
    t.stall_since = Clock::time_point{};  // the failure streak is over
    wake_next_highest_priority_blocked(/*from_free=*/false);
  }

  // returns true when the allocation should be retried (after blocking)
  bool post_alloc_failed_locked(ThreadInfo& t, long /*bytes*/,
                                int pool = POOL_DEVICE) {
    if (++t.retry_count >= MAX_RETRIES) {
      set_state(t, State::RUNNING, "retry_cap");
      return false;  // hard OOM
    }
    if (t.state == State::ALLOC_FREE) {
      // memory was freed while we were allocating: retry right away
      set_state(t, State::ALLOC, "retry_after_free");
      set_state(t, State::RUNNING, "");
      return true;
    }
    t.blocked_pool = pool;
    set_state(t, State::BLOCKED,
              pool == POOL_HOST ? "host_alloc_failed" : "alloc_failed");
    t.blocked_since = Clock::now();
    if (t.stall_since == Clock::time_point{}) t.stall_since = t.blocked_since;
    check_and_update_for_bufn_locked();
    return true;
  }

  bool thread_is_blocked(const ThreadInfo& t) {
    switch (t.state) {
      case State::BLOCKED:
      case State::BUFN:
      case State::BUFN_WAIT:
      case State::BUFN_THROW:
        return true;
      default:
        break;
    }
    if (blocked_cb_) return blocked_cb_(t.thread_id) != 0;
    return false;
  }

  // deadlock scan (reference is_in_deadlock / check_and_update_for_bufn):
  // returns true when it broke a deadlock
  bool check_and_update_for_bufn_locked() {
    // every thread attached to any task must be blocked for a deadlock
    bool any = false;
    for (auto& [task, tids] : task_threads_) {
      for (long tid : tids) {
        auto it = threads_.find(tid);
        if (it == threads_.end()) continue;
        any = true;
        if (!thread_is_blocked(it->second)) return false;
      }
    }
    if (!any) return false;

    // prefer rolling back the lowest-priority BLOCKED thread
    ThreadInfo* victim = nullptr;
    for (auto& [id, t] : threads_) {
      if (t.state != State::BLOCKED || t.tasks.empty()) continue;
      if (!victim || t.priority() < victim->priority()) victim = &t;
    }
    if (victim) {
      set_state(*victim, State::BUFN_THROW, "deadlock");
      victim->cv.notify_all();
      return true;
    }

    // all BUFN: the highest-priority one must split and push through
    ThreadInfo* chosen = nullptr;
    for (auto& [id, t] : threads_) {
      if (t.state != State::BUFN || t.tasks.empty()) continue;
      if (!chosen || t.priority() > chosen->priority()) chosen = &t;
    }
    if (chosen) {
      set_state(*chosen, State::SPLIT_THROW, "all_bufn");
      chosen->cv.notify_all();
      return true;
    }
    return false;
  }

  // pool >= 0: prefer threads blocked on THAT pool (a host free cannot
  // unblock a device-starved thread); fall back to any blocked thread —
  // waking the wrong one is safe (its retry fails and re-blocks).
  void wake_next_highest_priority_blocked(bool from_free, int pool = -1) {
    ThreadInfo* best = nullptr;
    for (int pass = 0; pass < 2 && !best; pass++) {
      for (auto& [id, t] : threads_) {
        if (t.state != State::BLOCKED) continue;
        if (pass == 0 && pool >= 0 && t.blocked_pool != pool) continue;
        if (!best || t.priority() > best->priority()) best = &t;
      }
      if (pool < 0) break;  // no preference: one pass is the full scan
    }
    if (best) {
      add_block_time(*best);
      set_state(*best, State::RUNNING, "woken");
      best->cv.notify_all();
      return;
    }
    if (from_free) {
      // no one plain-BLOCKED: rescue the highest-priority BUFN thread
      for (auto& [id, t] : threads_) {
        if (t.state != State::BUFN) continue;
        if (!best || t.priority() > best->priority()) best = &t;
      }
      if (best) {
        add_block_time(*best);
        set_state(*best, State::RUNNING, "bufn_rescue");
        best->cv.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::map<long, ThreadInfo> threads_;
  std::map<long, std::set<long>> task_threads_;
  std::map<long, TaskMetrics> metrics_;
  long pool_bytes_[NUM_POOLS] = {0, 0};
  long free_bytes_[NUM_POOLS] = {0, 0};
  long allocated_[NUM_POOLS] = {0, 0};
  long max_allocated_[NUM_POOLS] = {0, 0};
  BlockedCb blocked_cb_ = nullptr;
  std::FILE* log_ = nullptr;
};

}  // namespace

extern "C" {

void* tra_create(long pool_bytes, const char* log_path) {
  return new ResourceAdaptor(pool_bytes, log_path);
}
void tra_destroy(void* h) { delete static_cast<ResourceAdaptor*>(h); }

void tra_set_blocked_callback(void* h, int (*cb)(long)) {
  static_cast<ResourceAdaptor*>(h)->set_blocked_callback(cb);
}
void tra_start_dedicated_task_thread(void* h, long tid, long task) {
  static_cast<ResourceAdaptor*>(h)->start_dedicated_task_thread(tid, task);
}
void tra_pool_thread_working_on_tasks(void* h, int shuffle, long tid,
                                      const long* tasks, int n) {
  static_cast<ResourceAdaptor*>(h)->pool_thread_working_on_tasks(
      shuffle != 0, tid, tasks, n);
}
void tra_pool_thread_finished_for_tasks(void* h, long tid, const long* tasks,
                                        int n) {
  static_cast<ResourceAdaptor*>(h)->pool_thread_finished_for_tasks(tid, tasks,
                                                                   n);
}
void tra_remove_thread_association(void* h, long tid, long task) {
  static_cast<ResourceAdaptor*>(h)->remove_thread_association(tid, task);
}
void tra_task_done(void* h, long task) {
  static_cast<ResourceAdaptor*>(h)->task_done(task);
}
int tra_allocate(void* h, long tid, long bytes) {
  return static_cast<ResourceAdaptor*>(h)->allocate(tid, bytes, nullptr);
}
int tra_device_alloc_failed(void* h, long tid) {
  return static_cast<ResourceAdaptor*>(h)->device_alloc_failed(tid);
}
void tra_alloc_recovered(void* h, long tid) {
  static_cast<ResourceAdaptor*>(h)->alloc_recovered(tid);
}
void tra_resize_pool(void* h, long new_pool_bytes) {
  static_cast<ResourceAdaptor*>(h)->resize_pool(new_pool_bytes);
}
/* ---- unified second (host) pool: same thread state machine ---------- */
void tra_set_host_pool(void* h, long bytes) {
  static_cast<ResourceAdaptor*>(h)->set_host_pool(bytes);
}
int tra_allocate_on(void* h, long tid, long bytes, int pool) {
  return static_cast<ResourceAdaptor*>(h)->allocate(tid, bytes, nullptr,
                                                    pool);
}
void tra_deallocate_on(void* h, long tid, long bytes, int pool) {
  static_cast<ResourceAdaptor*>(h)->deallocate(tid, bytes, pool);
}
long tra_total_allocated_on(void* h, int pool) {
  return static_cast<ResourceAdaptor*>(h)->total_allocated(pool);
}
void tra_deallocate(void* h, long tid, long bytes) {
  static_cast<ResourceAdaptor*>(h)->deallocate(tid, bytes);
}
int tra_block_thread_until_ready(void* h, long tid) {
  return static_cast<ResourceAdaptor*>(h)->block_thread_until_ready(tid);
}
int tra_get_state_of(void* h, long tid) {
  return static_cast<ResourceAdaptor*>(h)->get_state_of(tid);
}
int tra_check_and_break_deadlocks(void* h) {
  return static_cast<ResourceAdaptor*>(h)->check_and_break_deadlocks();
}
int tra_break_stalled_cycles(void* h, long stall_ms) {
  return static_cast<ResourceAdaptor*>(h)->break_stalled_cycles(stall_ms);
}
void tra_force_retry_oom(void* h, long tid, int count, int skip) {
  static_cast<ResourceAdaptor*>(h)->force_retry_oom(tid, count, skip);
}
void tra_force_split_retry_oom(void* h, long tid, int count, int skip) {
  static_cast<ResourceAdaptor*>(h)->force_split_retry_oom(tid, count, skip);
}
void tra_force_cudf_exception(void* h, long tid, int count, int skip) {
  static_cast<ResourceAdaptor*>(h)->force_exception(tid, count, skip);
}
long tra_get_and_reset_metric(void* h, long task, int which) {
  return static_cast<ResourceAdaptor*>(h)->get_and_reset_metric(task, which);
}
long tra_total_allocated(void* h) {
  return static_cast<ResourceAdaptor*>(h)->total_allocated();
}
long tra_max_allocated(void* h) {
  return static_cast<ResourceAdaptor*>(h)->max_allocated();
}

}  // extern "C"

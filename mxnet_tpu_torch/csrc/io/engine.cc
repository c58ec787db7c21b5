// Threaded dependency engine.
//
// Parity: src/engine/threaded_engine.{h,cc} + threaded_engine_perdevice.cc —
// ops are closures pushed with read (const) / write (mutable) variable
// lists; the engine tracks per-variable reader/writer queues (the
// ThreadedVar protocol, threaded_engine.h:71-215), dispatches ready ops
// onto a worker thread pool, and propagates exceptions to WaitForVar /
// WaitForAll sync points (threaded_engine.cc:422-434).
//
// The device dataflow is CUDA streams' job; this engine schedules the
// host side of the runtime — data-pipeline stages, custom-op callbacks,
// checkpoint IO — with the same ordering semantics the reference gives
// every op.  Exposed through a C ABI consumed by ctypes.  The port's copy
// of src_native/engine.cc, built into the same library as the IO code.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Callback = void (*)(void*);

struct Opr;

// One scheduling variable (parity: ThreadedVar, threaded_engine.h:71).
struct Var {
  std::mutex m;
  // queue entries: (op, is_write).  Readers at the front of the queue are
  // granted together; a writer waits for exclusive access.
  std::deque<std::pair<Opr*, bool>> queue;
  int pending_reads = 0;
  bool writing = false;
};

struct Opr {
  Callback fn;
  void* arg;
  std::vector<Var*> use;      // const vars (read)
  std::vector<Var*> mutate;   // mutable vars (write)
  std::atomic<int> wait{0};
};

class Engine {
 public:
  explicit Engine(int num_workers) : shutdown_(false) {
    for (int i = 0; i < num_workers; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Engine() {
    WaitForAll();
    {
      std::lock_guard<std::mutex> lk(qm_);
      shutdown_ = true;
    }
    qcv_.notify_all();
    for (auto& t : workers_) t.join();
    for (auto& kv : vars_) delete kv.second;
  }

  int64_t NewVar() {
    std::lock_guard<std::mutex> lk(vm_);
    int64_t id = next_var_++;
    vars_[id] = new Var();
    return id;
  }

  Var* GetVar(int64_t id) {
    std::lock_guard<std::mutex> lk(vm_);
    auto it = vars_.find(id);
    return it == vars_.end() ? nullptr : it->second;
  }

  // parity: Engine::PushAsync (threaded_engine.cc:318)
  bool Push(Callback fn, void* arg, const int64_t* use, int n_use,
            const int64_t* mutate, int n_mut) {
    auto* op = new Opr();
    op->fn = fn;
    op->arg = arg;
    for (int i = 0; i < n_use; ++i) {
      Var* v = GetVar(use[i]);
      if (!v) return false;
      op->use.push_back(v);
    }
    for (int i = 0; i < n_mut; ++i) {
      Var* v = GetVar(mutate[i]);
      if (!v) return false;
      op->mutate.push_back(v);
    }
    op->wait.store(static_cast<int>(op->use.size() + op->mutate.size()) + 1);
    pending_.fetch_add(1);
    for (Var* v : op->use) AddReader(v, op);
    for (Var* v : op->mutate) AddWriter(v, op);
    DepGranted(op);  // the +1 sentinel: all deps registered
    return true;
  }

  // parity: Engine::WaitForVar (threaded_engine.cc:379) — blocks until
  // every op touching the var at call time has completed.
  bool WaitForVar(int64_t var_id) {
    Var* v = GetVar(var_id);
    if (!v) return false;
    // push a synchronous marker op that writes the var, wait for it
    std::mutex m;
    std::condition_variable cv;
    bool done = false;
    struct Ctx { std::mutex* m; std::condition_variable* cv; bool* done; };
    Ctx ctx{&m, &cv, &done};
    auto marker = [](void* p) {
      auto* c = static_cast<Ctx*>(p);
      std::lock_guard<std::mutex> lk(*c->m);
      *c->done = true;
      c->cv->notify_all();
    };
    int64_t vid = var_id;
    if (!Push(marker, &ctx, nullptr, 0, &vid, 1)) return false;
    std::unique_lock<std::mutex> lk(m);
    cv.wait(lk, [&] { return done; });
    return true;
  }

  void WaitForAll() {
    std::unique_lock<std::mutex> lk(pm_);
    pcv_.wait(lk, [&] { return pending_.load() == 0; });
  }

  void SetError(const char* msg) {
    std::lock_guard<std::mutex> lk(em_);
    if (error_.empty()) error_ = msg;
  }

  std::string TakeError() {
    std::lock_guard<std::mutex> lk(em_);
    std::string out;
    std::swap(out, error_);
    return out;
  }

 private:
  void AddReader(Var* v, Opr* op) {
    bool ready = false;
    {
      std::lock_guard<std::mutex> lk(v->m);
      if (!v->writing && v->queue.empty()) {
        ++v->pending_reads;
        ready = true;
      } else {
        v->queue.emplace_back(op, false);
      }
    }
    if (ready) DepGranted(op);
  }

  void AddWriter(Var* v, Opr* op) {
    bool ready = false;
    {
      std::lock_guard<std::mutex> lk(v->m);
      if (!v->writing && v->pending_reads == 0 && v->queue.empty()) {
        v->writing = true;
        ready = true;
      } else {
        v->queue.emplace_back(op, true);
      }
    }
    if (ready) DepGranted(op);
  }

  // parity: ThreadedEngine::OnComplete (threaded_engine.cc:441)
  void Complete(Opr* op) {
    std::vector<Opr*> newly_ready;
    for (Var* v : op->use) {
      std::lock_guard<std::mutex> lk(v->m);
      if (--v->pending_reads == 0) GrantNext(v, &newly_ready);
    }
    for (Var* v : op->mutate) {
      std::lock_guard<std::mutex> lk(v->m);
      v->writing = false;
      GrantNext(v, &newly_ready);
    }
    delete op;
    for (Opr* o : newly_ready) DepGranted(o);
    if (pending_.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk(pm_);
      pcv_.notify_all();
    }
  }

  // var lock held by caller
  void GrantNext(Var* v, std::vector<Opr*>* out) {
    if (v->writing || v->pending_reads > 0) return;
    while (!v->queue.empty()) {
      auto [op, is_write] = v->queue.front();
      if (is_write) {
        if (v->pending_reads == 0 && !v->writing) {
          v->queue.pop_front();
          v->writing = true;
          out->push_back(op);
        }
        break;
      }
      v->queue.pop_front();
      ++v->pending_reads;
      out->push_back(op);
    }
  }

  void DepGranted(Opr* op) {
    if (op->wait.fetch_sub(1) == 1) {
      {
        std::lock_guard<std::mutex> lk(qm_);
        ready_.push(op);
      }
      qcv_.notify_one();
    }
  }

  void WorkerLoop() {
    for (;;) {
      Opr* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(qm_);
        qcv_.wait(lk, [&] { return shutdown_ || !ready_.empty(); });
        if (shutdown_ && ready_.empty()) return;
        op = ready_.front();
        ready_.pop();
      }
      // the callback reports Python exceptions via EngineSetError; C++
      // exceptions cannot cross the C ABI, so guard anyway
      try {
        op->fn(op->arg);
      } catch (const std::exception& e) {
        SetError(e.what());
      } catch (...) {
        SetError("unknown engine op error");
      }
      Complete(op);
    }
  }

  std::vector<std::thread> workers_;
  std::mutex qm_;
  std::condition_variable qcv_;
  std::queue<Opr*> ready_;
  bool shutdown_;

  std::mutex vm_;
  std::unordered_map<int64_t, Var*> vars_;
  int64_t next_var_ = 1;

  std::atomic<int64_t> pending_{0};
  std::mutex pm_;
  std::condition_variable pcv_;

  std::mutex em_;
  std::string error_;
};

}  // namespace

extern "C" {

void* EngineCreate(int num_workers) {
  if (num_workers <= 0) num_workers = std::thread::hardware_concurrency();
  return new Engine(num_workers);
}

void EngineDestroy(void* h) { delete static_cast<Engine*>(h); }

int64_t EngineNewVar(void* h) { return static_cast<Engine*>(h)->NewVar(); }

int EnginePushAsync(void* h, void (*fn)(void*), void* arg,
                    const int64_t* use, int n_use, const int64_t* mutate,
                    int n_mut) {
  return static_cast<Engine*>(h)->Push(fn, arg, use, n_use, mutate, n_mut)
             ? 0
             : -1;
}

int EngineWaitForVar(void* h, int64_t var_id) {
  return static_cast<Engine*>(h)->WaitForVar(var_id) ? 0 : -1;
}

void EngineWaitForAll(void* h) { static_cast<Engine*>(h)->WaitForAll(); }

void EngineSetError(void* h, const char* msg) {
  static_cast<Engine*>(h)->SetError(msg);
}

// copies the pending error (if any) into buf, clears it; returns length
int EngineGetError(void* h, char* buf, int buf_len) {
  std::string e = static_cast<Engine*>(h)->TakeError();
  if (e.empty()) return 0;
  int n = static_cast<int>(e.size());
  if (n >= buf_len) n = buf_len - 1;
  std::memcpy(buf, e.data(), n);
  buf[n] = '\0';
  return n;
}

int mxnet_tpu_lib_version() { return 1; }

}  // extern "C"

#include "controller.h"

#include <algorithm>
#include <cstdio>
#include <cctype>
#include <cstdlib>

namespace hvdtpu {

namespace {

long CtlEnvLong(const char* name, long def) {
  const char* v = getenv(name);
  if (!v || !*v) return def;
  return strtol(v, nullptr, 10);
}

bool CtlEnvBool(const char* name, bool def) {
  const char* v = getenv(name);
  if (!v || !*v) return def;
  std::string s(v);
  for (auto& c : s) c = static_cast<char>(tolower(c));
  // Same truthy set as the Python knob parser (common/knobs.py).
  return s == "1" || s == "true" || s == "yes" || s == "on";
}

// Leading token of the signature is the dtype (frontend contract:
// "dtype:shape:op:..."), used for same-dtype fusion grouping like the
// reference's dtype look-ahead (controller.cc:778-915).
std::string SigDtype(const std::string& sig) {
  auto pos = sig.find(':');
  return pos == std::string::npos ? sig : sig.substr(0, pos);
}

// Greedy fusion of consecutive OK responses with the same op + dtype under
// the byte threshold (reference: FuseResponses controller.cc:778-915).
class Fuser {
 public:
  explicit Fuser(int64_t threshold) : threshold_(threshold) {}

  void Add(Response r, const std::string& dtype) {
    bool can_fuse = false;
    if (r.type == ResponseType::OK && !out_.empty()) {
      Response& last = out_.back();
      can_fuse = last.type == ResponseType::OK && last.op == r.op &&
                 last_dtype_ == dtype &&
                 last.total_bytes + r.total_bytes <= threshold_;
    }
    if (can_fuse) {
      Response& last = out_.back();
      last.names.insert(last.names.end(), r.names.begin(), r.names.end());
      last.sigs.insert(last.sigs.end(), r.sigs.begin(), r.sigs.end());
      last.sizes.insert(last.sizes.end(), r.sizes.begin(), r.sizes.end());
      last.total_bytes += r.total_bytes;
    } else {
      out_.push_back(std::move(r));
      last_dtype_ = dtype;
    }
  }

  std::vector<Response>& out() { return out_; }

 private:
  int64_t threshold_;
  std::string last_dtype_;
  std::vector<Response> out_;
};

// Fixed-size bit-vector helpers (bit i = cache slot i).
std::string PackBits(const std::vector<char>& bits) {
  std::string out((bits.size() + 7) / 8, '\0');
  for (size_t i = 0; i < bits.size(); i++)
    if (bits[i]) out[i / 8] |= static_cast<char>(1 << (i % 8));
  return out;
}

std::vector<char> UnpackBits(const std::string& s, size_t n) {
  std::vector<char> bits(n, 0);
  for (size_t i = 0; i < n && i / 8 < s.size(); i++)
    bits[i] = (s[i / 8] >> (i % 8)) & 1;
  return bits;
}

}  // namespace

Controller::Controller(Transport* transport, const ControllerOptions& opts)
    : transport_(transport), opts_(opts) {
  // The bypass knobs reach the native layer through env (the chaos/retry
  // precedent, transport.cc): the C-API create signatures stay stable.
  opts_.bypass_enabled =
      CtlEnvBool("HOROVOD_BYPASS", opts_.bypass_enabled);
  long k = CtlEnvLong("HOROVOD_BYPASS_STABLE_CYCLES",
                      opts_.bypass_stable_cycles);
  if (k >= 1) opts_.bypass_stable_cycles = static_cast<int>(k);
  fusion_threshold_.store(opts_.fusion_threshold_bytes,
                          std::memory_order_relaxed);
}

// ---------------------------------------------------------- plan-epoch bypass
void Controller::BreakEpochLocked(const char* reason) {
  if (!epoch_locked_.load(std::memory_order_acquire)) return;
  epoch_locked_.store(false, std::memory_order_release);
  stats_.epoch_invalidations++;
  // Partial-round submissions re-materialize through carry_ — the full
  // path renegotiates them (the submitter cannot resubmit past the
  // DUPLICATE_NAME guard, the ReplicaErase precedent).
  for (auto& r : round_received_) carry_.push_back(std::move(r));
  round_received_.clear();
  round_names_.clear();
  round_missing_.clear();
  round_emitted_ = 0;
  // Relocking needs K fresh stable bursts observed on the wire.
  r0_burst_sig_.clear();
  r0_last_sig_.clear();
  r0_burst_valid_ = false;
  r0_stable_ = 0;
  burst_plan_.clear();
  burst_valid_ = false;
  // A locked worker only rejoins the lock-step wire when it deviates
  // itself or sees a kick; rank 0 therefore announces every local break
  // before its next gather so the fleet converges promptly.
  if (rank() == 0) kick_pending_ = true;
  if (trace_ != nullptr && trace_->enabled())
    trace_->Record('i', 'c', "epoch.invalidate",
                   static_cast<int64_t>(epoch_));
  (void)reason;
}

void Controller::BreakEpoch(const char* reason) {
  std::lock_guard<std::mutex> lk(bypass_mu_);
  BreakEpochLocked(reason);
}

Controller::BypassResult Controller::TryBypassSubmit(
    const Request& req, std::vector<Response>* out) {
  std::lock_guard<std::mutex> lk(bypass_mu_);
  if (!epoch_locked_.load(std::memory_order_acquire))
    return BypassResult::kNotLocked;
  if (req.type == RequestType::JOIN) {
    BreakEpochLocked("join");
    return BypassResult::kBreak;
  }
  auto it = locked_set_.find(req.name);
  if (it == locked_set_.end() || it->second.first != req.signature ||
      it->second.second != req.type || round_names_.count(req.name)) {
    // New tensor, changed signature, or a resubmission before the round
    // completed (a tensor of the locked set went missing): the steady
    // state is over — renegotiate.
    BreakEpochLocked("deviation");
    return BypassResult::kBreak;
  }
  if (round_received_.empty()) {
    round_started_ = std::chrono::steady_clock::now();
    if (trace_ != nullptr && trace_->enabled())
      trace_->Record('B', 'c', "cycle.bypass",
                     static_cast<int64_t>(epoch_));
  }
  round_names_.insert(req.name);
  round_received_.push_back(req);
  stats_.cache_hits++;
  round_missing_[plan_batch_of_[req.name]]--;
  // Emit completed batches strictly in plan order — the identical global
  // order every rank's negotiated steady step produced.
  while (round_emitted_ < locked_plan_.size() &&
         round_missing_[round_emitted_] == 0) {
    const Response& r = locked_plan_[round_emitted_];
    out->push_back(r);
    stats_.cached_responses += r.names.size();
    stats_.fused_batches++;
    stats_.fused_batch_bytes += static_cast<uint64_t>(r.total_bytes);
    stats_.tensors_negotiated += r.names.size();
    if (r.op == RequestType::ALLREDUCE ||
        r.op == RequestType::REDUCESCATTER)
      stats_.bytes_reduced += static_cast<uint64_t>(r.total_bytes);
    round_emitted_++;
  }
  if (round_emitted_ == locked_plan_.size()) {
    // One steady step served with zero transport round trips.
    stats_.bypass_cycles++;
    if (trace_ != nullptr && trace_->enabled())
      trace_->Record('E', 'c', "cycle.bypass",
                     static_cast<int64_t>(round_received_.size()));
    round_received_.clear();
    round_names_.clear();
    round_emitted_ = 0;
    for (size_t i = 0; i < locked_plan_.size(); i++)
      round_missing_[i] = static_cast<int>(locked_plan_[i].names.size());
  }
  return BypassResult::kServed;
}

bool Controller::BypassRoundTimedOut() {
  std::lock_guard<std::mutex> lk(bypass_mu_);
  if (!epoch_locked_.load(std::memory_order_acquire) ||
      round_received_.empty())
    return false;
  double age = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - round_started_).count();
  if (age <= opts_.bypass_partial_round_break_seconds) return false;
  fprintf(stderr,
          "[hvd_tpu_core] WARNING: locked-epoch replay round partial for "
          "%.1fs (%zu/%zu batches) — tensor missing from the steady set; "
          "falling back to full negotiation\n",
          age, round_emitted_, locked_plan_.size());
  BreakEpochLocked("partial-round-timeout");
  return true;
}

// ------------------------------------------------------------- cache replica
void Controller::ReplicaInsert(const std::string& name, const std::string& sig,
                               RequestType op, int64_t bytes) {
  if (opts_.cache_capacity <= 0) return;
  auto it = slot_of_.find(name);
  if (it != slot_of_.end()) {  // re-negotiated (e.g. after invalidation race)
    CacheSlot& s = replica_[it->second];
    s.sig = sig;
    s.op = op;
    s.bytes = bytes;
    s.valid = true;
    return;
  }
  // Reuse an invalid slot if any; else grow; else evict the oldest (FIFO) —
  // every rank performs the same sequence on the same broadcast data, so
  // slot assignment stays identical everywhere.
  int slot = -1;
  for (size_t i = 0; i < replica_.size(); i++) {
    if (!replica_[i].valid) {
      slot = static_cast<int>(i);
      break;
    }
  }
  if (slot < 0) {
    if (static_cast<int>(replica_.size()) < opts_.cache_capacity) {
      slot = static_cast<int>(replica_.size());
      replica_.emplace_back();
      local_hits_.push_back(0);
      local_inv_.push_back(0);
      partial_since_.emplace_back();
      partial_warned_.push_back(0);
    } else {
      while (!fifo_.empty()) {
        auto [s, n] = fifo_.front();
        fifo_.pop_front();
        if (replica_[s].valid && replica_[s].name == n) {
          ReplicaErase(s);
          slot = s;
          break;
        }
      }
      if (slot < 0) return;  // capacity 0 edge; nothing to evict into
    }
  }
  CacheSlot& s = replica_[slot];
  s.name = name;
  s.sig = sig;
  s.op = op;
  s.bytes = bytes;
  s.valid = true;
  slot_of_[name] = slot;
  fifo_.emplace_back(slot, name);
}

void Controller::ReplicaErase(int slot) {
  CacheSlot& s = replica_[slot];
  if (!s.valid) return;
  // A request of ours may be riding this slot's hit bit, still awaiting
  // global agreement.  Re-materialize it for the full path so the erase
  // (invalidation OR capacity eviction) can never drop an in-flight
  // collective — the submitter cannot resubmit (DUPLICATE_NAME guard).
  if (local_hits_[slot]) {
    Request r;
    r.rank = rank();
    r.type = s.op;
    r.name = s.name;
    r.signature = s.sig;
    r.bytes = s.bytes;
    // carry_ is shared with the bypass path (a submitter's thread can
    // refill it via BreakEpochLocked), hence the lock; never held here
    // already — no RunCycle caller reaches ReplicaErase under bypass_mu_.
    std::lock_guard<std::mutex> lk(bypass_mu_);
    carry_.push_back(std::move(r));
  }
  // Purge this slot's FIFO entry: a stale entry would later evict whatever
  // tensor reuses the slot as if it were the oldest.
  const std::string name = s.name;
  fifo_.remove_if([&](const std::pair<int, std::string>& e) {
    return e.first == slot && e.second == name;
  });
  slot_of_.erase(s.name);
  s.valid = false;
  s.name.clear();
  s.sig.clear();
  local_hits_[slot] = 0;
  local_inv_[slot] = 0;
  partial_warned_[slot] = 0;
  partial_since_[slot] = std::chrono::steady_clock::time_point();
}

// ----------------------------------------------------------------- rank0 side
void Controller::Ingest(const Request& req, int /*rank*/) {
  auto it = table_.find(req.name);
  if (it == table_.end()) {
    Entry e;
    e.first_seen = std::chrono::steady_clock::now();
    it = table_.emplace(req.name, std::move(e)).first;
    arrival_order_.push_back(req.name);
  }
  it->second.requests.push_back(req);
}

void Controller::CheckStalls() {
  auto now = std::chrono::steady_clock::now();
  for (auto& kv : table_) {
    double age = std::chrono::duration<double>(
        now - kv.second.first_seen).count();
    if (age > opts_.stall_warn_seconds && !kv.second.warned) {
      kv.second.warned = true;
      stats_.stall_warnings++;
      fprintf(stderr,
              "[hvd_tpu_core] WARNING: tensor %s submitted by %zu/%d ranks "
              "for %.0fs — possible stalled or diverged peer\n",
              kv.first.c_str(), kv.second.requests.size(), size(), age);
    }
  }
}

std::vector<Response> Controller::BuildResponses() {
  int n = size();
  if (joined_.empty()) joined_.assign(n, false);
  int num_joined = static_cast<int>(
      std::count(joined_.begin(), joined_.end(), true));

  Fuser fuser(fusion_threshold());
  std::vector<std::string> done_names;
  auto now = std::chrono::steady_clock::now();
  for (const auto& name : arrival_order_) {
    auto it = table_.find(name);
    if (it == table_.end()) continue;
    auto& entry = it->second;
    // Joined ranks implicitly contribute (reference: joined ranks feed
    // zeros, controller.cc:254-307).
    if (static_cast<int>(entry.requests.size()) + num_joined < n) continue;

    stats_.negotiation_age_us.Observe(static_cast<uint64_t>(
        std::chrono::duration_cast<std::chrono::microseconds>(
            now - entry.first_seen).count()));
    const Request& first = entry.requests.front();
    Response r;
    r.op = first.type;
    r.names = {name};
    r.sigs = {first.signature};
    r.sizes = {first.bytes};
    r.total_bytes = first.bytes;
    bool consistent = true;
    for (const auto& req : entry.requests) {
      if (req.signature != first.signature || req.type != first.type) {
        consistent = false;
        r.type = ResponseType::ERROR_;
        char buf[256];
        snprintf(buf, sizeof(buf),
                 "inconsistent submission for '%s': rank %d sent '%s', "
                 "rank %d sent '%s'",
                 name.c_str(), first.rank, first.signature.c_str(),
                 req.rank, req.signature.c_str());
        r.error_message = buf;
        break;
      }
    }
    if (consistent) r.type = ResponseType::OK;
    fuser.Add(std::move(r), SigDtype(first.signature));
    done_names.push_back(name);
  }
  for (const auto& name : done_names) {
    table_.erase(name);
    arrival_order_.erase(
        std::find(arrival_order_.begin(), arrival_order_.end(), name));
  }
  return std::move(fuser.out());
}

// ------------------------------------------------------------------ the cycle
bool Controller::RunCycle(const std::vector<Request>& pending,
                          bool shutdown_requested,
                          std::vector<Response>* out) {
  auto cycle_start = std::chrono::steady_clock::now();
  stats_.cycles++;
  // A rank-0 epoch break is announced to still-locked workers before the
  // gather (they only watch the wire through Peek while locked).
  {
    bool kick = false;
    {
      std::lock_guard<std::mutex> lk(bypass_mu_);
      kick = kick_pending_;
      kick_pending_ = false;
    }
    if (kick) transport_->Kick();
  }
  // Tracing: stamp the phase boundaries as the cycle runs, commit the
  // spans at the end only for non-idle cycles (trace.h RecordAt) — an
  // idle 1 ms loop must not flood the ring.
  bool traced = trace_ != nullptr && trace_->enabled();
  uint64_t t_negotiate = traced ? trace_->NowUs() : 0;
  uint64_t t_fuse = 0, t_respond = 0;
  int n = size();
  size_t nslots = replica_.size();
  if (joined_.empty()) joined_.assign(n, false);
  if (shutdown_.empty()) shutdown_.assign(n, false);

  // 1. Split local submissions: cache hits flip a bit; signature changes
  //    request invalidation and renegotiate; the rest go the full path.
  //    The carry_ handoff takes bypass_mu_: an epoch break on a
  //    submitter's thread may be refilling it concurrently.
  std::vector<Request> uncached;
  {
    std::lock_guard<std::mutex> lk(bypass_mu_);
    uncached = std::move(carry_);
    carry_.clear();
  }
  for (const auto& req : pending) {
    if (req.type == RequestType::JOIN || opts_.cache_capacity <= 0) {
      uncached.push_back(req);
      continue;
    }
    auto it = slot_of_.find(req.name);
    if (it != slot_of_.end()) {
      const CacheSlot& s = replica_[it->second];
      if (s.sig == req.signature && s.op == req.type) {
        local_hits_[it->second] = 1;
        stats_.cache_hits++;
        continue;
      }
      local_inv_[it->second] = 1;  // applied when globally agreed
    }
    stats_.cache_misses++;
    uncached.push_back(req);
  }

  // 2. Serialize + gather: [shutdown][nslots][hit bits][inv bits][requests]
  Writer w;
  w.u8(shutdown_requested ? 1 : 0);
  w.u32(static_cast<uint32_t>(nslots));
  w.str(PackBits(local_hits_));
  w.str(PackBits(local_inv_));
  w.u32(static_cast<uint32_t>(uncached.size()));
  for (const auto& r : uncached) SerializeRequest(r, &w);
  stats_.bytes_gathered += w.data().size();
  uint64_t cycle_bytes = w.data().size();

  std::vector<std::string> all;
  if (!transport_->Gather(w.data(), rank() == 0 ? &all : nullptr))
    return false;
  if (traced) t_fuse = trace_->NowUs();

  // 3. Rank 0: AND the hit bits (joined ranks count as all-ones), OR the
  //    invalidation bits, ingest uncached requests, build responses.
  std::string frame;
  if (rank() == 0) {
    std::vector<char> agreed(nslots, 1);
    std::vector<char> inv(nslots, 0);
    std::vector<char> any_hit(nslots, 0);
    for (int r = 0; r < n; r++) {
      Reader rd(all[r]);
      bool sd = rd.u8() != 0;
      if (sd) shutdown_[r] = true;
      uint32_t peer_slots = rd.u32();
      std::vector<char> hits = UnpackBits(rd.str(), nslots);
      std::vector<char> invs = UnpackBits(rd.str(), nslots);
      if (peer_slots != nslots) {
        // Lock-step protocol violation; degrade safely: no agreement.
        std::fill(hits.begin(), hits.end(), 0);
        std::fill(invs.begin(), invs.end(), 0);
      }
      bool is_joined = joined_[r];
      for (size_t i = 0; i < nslots; i++) {
        char h = is_joined ? 1 : hits[i];
        agreed[i] = agreed[i] & h;
        any_hit[i] = any_hit[i] | hits[i];
        inv[i] = inv[i] | invs[i];
      }
      uint32_t cnt = rd.u32();
      for (uint32_t i = 0; i < cnt; i++) {
        Request req = DeserializeRequest(&rd);
        if (req.type == RequestType::JOIN) {
          joined_[req.rank] = true;
          last_joined_ = req.rank;
        } else {
          Ingest(req, r);
        }
      }
    }
    // Partial-hit stall detection: some ranks hit a cached tensor, others
    // have not submitted it for too long -> warn and invalidate so the
    // tensor renegotiates through the full path, where per-tensor stall
    // reporting names the laggard (reference: stall-driven cache
    // invalidation, controller.cc:126-135).
    auto now = std::chrono::steady_clock::now();
    for (size_t i = 0; i < nslots; i++) {
      if (!replica_[i].valid) continue;
      if (agreed[i] || !any_hit[i]) {
        partial_since_[i] = std::chrono::steady_clock::time_point();
        continue;
      }
      if (partial_since_[i] == std::chrono::steady_clock::time_point()) {
        partial_since_[i] = now;
      } else if (!partial_warned_[i] &&
                 std::chrono::duration<double>(now - partial_since_[i])
                         .count() > opts_.stall_warn_seconds) {
        partial_warned_[i] = 1;
        stats_.stall_warnings++;
        fprintf(stderr,
                "[hvd_tpu_core] WARNING: cached tensor %s ready on some "
                "ranks only for %.0fs — invalidating for renegotiation\n",
                replica_[i].name.c_str(),
                std::chrono::duration<double>(now - partial_since_[i])
                    .count());
        inv[i] = 1;
      }
    }
    for (size_t i = 0; i < nslots; i++) {
      // Agreement needs every rank hit-or-joined AND at least one real hit
      // (all-joined ranks must not spuriously fire every cached tensor),
      // and no pending invalidation.
      agreed[i] = agreed[i] & any_hit[i] & static_cast<char>(!inv[i]);
    }

    CheckStalls();
    std::vector<Response> resp = BuildResponses();
    int num_joined = static_cast<int>(
        std::count(joined_.begin(), joined_.end(), true));
    if (num_joined == n) {
      Response j;
      j.type = ResponseType::JOIN_DONE;
      // Last-joined rank rides in total_bytes (reference: join() returns
      // the id of the last rank to join, torch/mpi_ops.py:882-897).
      j.total_bytes = last_joined_;
      resp.push_back(j);
      joined_.assign(n, false);
      last_joined_ = -1;
    }
    if (std::count(shutdown_.begin(), shutdown_.end(), true) == n) {
      Response s;
      s.type = ResponseType::SHUTDOWN;
      resp.push_back(s);
    }
    // Plan-epoch stability: fingerprint each burst of agreed-hit cycles.
    // A burst closes only on a genuinely IDLE cycle (nothing agreed,
    // nothing pending — the `busy` bit makes mid-step skew cycles
    // neutral rather than false boundaries); K identical consecutive
    // bursts arm the epoch-lock flag on the boundary broadcast.  The
    // counting uses EXACTLY the values serialized below, so the flag is
    // consistent with what every rank applies.
    uint8_t epoch_flags = 0;  // bit 0: lock, bit 1: busy (not a boundary)
    if (opts_.bypass_enabled && opts_.cache_capacity > 0) {
      bool any_agreed = std::any_of(agreed.begin(), agreed.end(),
                                    [](char c) { return c != 0; });
      bool any_inv = std::any_of(inv.begin(), inv.end(),
                                 [](char c) { return c != 0; });
      bool busy = !table_.empty() ||
                  std::any_of(any_hit.begin(), any_hit.end(),
                              [](char c) { return c != 0; });
      if (busy) epoch_flags |= 2;
      std::lock_guard<std::mutex> lk(bypass_mu_);
      if (any_inv || !resp.empty()) {
        // Negotiation completed (or membership/shutdown traffic): the
        // tensor set is not steady — restart the stability count.
        r0_burst_sig_.clear();
        r0_last_sig_.clear();
        r0_burst_valid_ = false;
        r0_stable_ = 0;
      } else if (any_agreed) {  // contributing cycle: extend the burst
        if (r0_burst_valid_) {
          // Union of agreed slots, NOT per-cycle concat: how a step's
          // agreements chunk across cycles is timing-dependent, but the
          // tensor SET is the steady-state invariant being fingerprinted.
          std::string bits = PackBits(agreed);
          if (r0_burst_sig_.size() < bits.size())
            r0_burst_sig_.resize(bits.size(), '\0');
          for (size_t i = 0; i < bits.size(); i++)
            r0_burst_sig_[i] |= bits[i];
        }
      } else if (!busy) {  // idle cycle = burst boundary
        if (r0_burst_valid_ && !r0_burst_sig_.empty()) {
          if (r0_burst_sig_ == r0_last_sig_) {
            r0_stable_++;
          } else {
            r0_stable_ = 1;
            r0_last_sig_ = r0_burst_sig_;
          }
          if (r0_stable_ >= opts_.bypass_stable_cycles &&
              !epoch_locked_.load(std::memory_order_acquire)) {
            epoch_flags |= 1;
            r0_stable_ = 0;
          }
        }
        r0_burst_sig_.clear();
        r0_burst_valid_ = true;
      }
      // busy && !any_agreed: mid-step skew — neutral, burst stays open.
    }
    // 4. Broadcast: [nslots][agreed bits][inv bits][epoch flags]
    //    [negotiated responses]
    Writer rw;
    rw.u32(static_cast<uint32_t>(nslots));
    rw.str(PackBits(agreed));
    rw.str(PackBits(inv));
    rw.u8(epoch_flags);
    rw.u32(static_cast<uint32_t>(resp.size()));
    for (const auto& r : resp) SerializeResponse(r, &rw);
    frame = rw.data();
  }

  if (traced) t_respond = trace_->NowUs();
  if (!transport_->Bcast(&frame)) return false;
  stats_.bytes_broadcast += frame.size();
  cycle_bytes += frame.size();
  stats_.last_cycle_bytes = cycle_bytes;

  // 5. Every rank applies the broadcast identically: invalidations first,
  //    then cached responses in slot order, then negotiated responses, then
  //    replica insertion of newly negotiated tensors.
  Reader rd(frame);
  uint32_t bc_slots = rd.u32();
  std::vector<char> agreed = UnpackBits(rd.str(), bc_slots);
  std::vector<char> inv = UnpackBits(rd.str(), bc_slots);
  uint8_t epoch_flags = rd.u8();

  for (uint32_t i = 0; i < bc_slots && i < replica_.size(); i++) {
    if (!inv[i] || !replica_[i].valid) continue;
    // ReplicaErase re-materializes any request riding this slot's hit bit.
    ReplicaErase(static_cast<int>(i));
  }

  out->clear();
  Fuser cached(fusion_threshold());
  for (uint32_t i = 0; i < bc_slots && i < replica_.size(); i++) {
    if (!agreed[i] || !replica_[i].valid) continue;
    const CacheSlot& s = replica_[i];
    Response r;
    r.type = ResponseType::OK;
    r.op = s.op;
    r.names = {s.name};
    r.sigs = {s.sig};
    r.sizes = {s.bytes};
    r.total_bytes = s.bytes;
    cached.Add(std::move(r), SigDtype(s.sig));
    local_hits_[i] = 0;
    local_inv_[i] = 0;
    stats_.cached_responses++;
  }
  *out = std::move(cached.out());

  uint32_t cnt = rd.u32();
  // Plan-epoch accumulation + lock application: driven purely by the
  // broadcast content just parsed (agreed/inv bits, negotiated count,
  // lock flag) and the cached responses reconstructed above — identical
  // inputs on every rank, so every rank freezes the identical plan.
  if (opts_.bypass_enabled && opts_.cache_capacity > 0) {
    bool any_agreed = std::any_of(agreed.begin(), agreed.end(),
                                  [](char c) { return c != 0; });
    bool any_inv = std::any_of(inv.begin(), inv.end(),
                               [](char c) { return c != 0; });
    bool busy = (epoch_flags & 2) != 0;
    std::lock_guard<std::mutex> lk(bypass_mu_);
    if (any_inv || cnt > 0) {
      burst_plan_.clear();
      burst_valid_ = false;
    } else if (any_agreed) {
      // Contributing cycle: its cached responses extend the burst (out
      // currently holds exactly the cached portion).
      if (burst_valid_)
        burst_plan_.insert(burst_plan_.end(), out->begin(), out->end());
    } else if (!busy) {  // idle cycle = burst boundary
      if ((epoch_flags & 1) && burst_valid_ && !burst_plan_.empty() &&
          !epoch_locked_.load(std::memory_order_acquire)) {
        locked_plan_ = burst_plan_;
        locked_set_.clear();
        plan_batch_of_.clear();
        round_missing_.assign(locked_plan_.size(), 0);
        for (size_t b = 0; b < locked_plan_.size(); b++) {
          const Response& r = locked_plan_[b];
          round_missing_[b] = static_cast<int>(r.names.size());
          for (size_t t = 0; t < r.names.size(); t++) {
            plan_batch_of_[r.names[t]] = static_cast<int>(b);
            locked_set_[r.names[t]] = {
                t < r.sigs.size() ? r.sigs[t] : "", r.op};
          }
        }
        round_received_.clear();
        round_names_.clear();
        round_emitted_ = 0;
        epoch_++;
        stats_.epoch_locks++;
        epoch_locked_.store(true, std::memory_order_release);
        if (trace_ != nullptr && trace_->enabled())
          trace_->Record('i', 'c', "epoch.lock",
                         static_cast<int64_t>(epoch_));
      }
      burst_plan_.clear();
      burst_valid_ = true;
    }
    // busy && !any_agreed: mid-step skew — neutral, burst stays open.
  }
  out->reserve(out->size() + cnt);
  for (uint32_t i = 0; i < cnt; i++) {
    Response r = DeserializeResponse(&rd);
    if (r.type == ResponseType::OK) {
      for (size_t t = 0; t < r.names.size(); t++) {
        ReplicaInsert(r.names[t], t < r.sigs.size() ? r.sigs[t] : "",
                      r.op, t < r.sizes.size() ? r.sizes[t] : 0);
      }
    }
    out->push_back(std::move(r));
  }
  if (rank() == 0) stats_.responses += out->size();
  // Fused-batch + payload accounting (identical on every rank: `out` is
  // reconstructed from the same broadcast data everywhere).
  for (const auto& r : *out) {
    if (r.type != ResponseType::OK) continue;
    stats_.fused_batches++;
    stats_.fused_batch_bytes += static_cast<uint64_t>(r.total_bytes);
    stats_.tensors_negotiated += r.names.size();
    if (r.op == RequestType::ALLREDUCE ||
        r.op == RequestType::REDUCESCATTER)
      stats_.bytes_reduced += static_cast<uint64_t>(r.total_bytes);
  }
  stats_.cycle_time_us.Observe(static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::microseconds>(
          std::chrono::steady_clock::now() - cycle_start).count()));
  if (traced && (!pending.empty() || !out->empty())) {
    // negotiate = local split + serialize + lock-step gather; fuse =
    // rank-0 ingest/validate/fuse + frame build; respond = broadcast +
    // replica apply (workers spend "fuse" waiting on rank 0's build, the
    // honest cross-rank picture: that wait IS the negotiation cost).
    uint64_t t_end = trace_->NowUs();
    trace_->RecordAt(t_negotiate, 'B', 'c', "cycle.negotiate",
                     static_cast<int64_t>(pending.size()));
    trace_->RecordAt(t_fuse, 'E', 'c', "cycle.negotiate");
    trace_->RecordAt(t_fuse, 'B', 'c', "cycle.fuse");
    trace_->RecordAt(t_respond, 'E', 'c', "cycle.fuse");
    trace_->RecordAt(t_respond, 'B', 'c', "cycle.respond");
    trace_->RecordAt(t_end, 'E', 'c', "cycle.respond",
                     static_cast<int64_t>(out->size()));
  }
  return true;
}

}  // namespace hvdtpu

// Core types for the native coordination runtime.
//
// TPU-native rethink of the reference's common.h (reference:
// horovod/common/common.h, message.h): the data plane is XLA/ICI driven from
// Python, so the native layer carries *metadata only* — which named
// collectives each process has submitted, their signatures (shape/dtype/op
// encoded by the frontend), and the globally-agreed execution order.  No
// tensor payloads cross this layer; Requests shrink to (name, signature,
// type, bytes) and Responses to ordered fused batches of names.
//
// Wire format: hand-rolled length-prefixed binary instead of FlatBuffers
// (reference: wire/message.fbs) — the messages are tiny and the schema is
// stable, so zero-dependency serialization wins.

#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace hvdtpu {

enum class RequestType : uint8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  ALLTOALL = 3,
  REDUCESCATTER = 4,
  BARRIER = 5,
  JOIN = 6,
};

enum class ResponseType : uint8_t {
  OK = 0,        // execute this fused batch of tensors
  ERROR_ = 1,    // signature mismatch across ranks; msg in error_message
  JOIN_DONE = 2, // all ranks joined; training may stop
  SHUTDOWN = 3,
};

// One rank's declaration that a named collective is locally ready.
// (reference: Request, message.h:50-120)
struct Request {
  int32_t rank = 0;
  RequestType type = RequestType::ALLREDUCE;
  std::string name;
  std::string signature;  // frontend-encoded "dtype:shape:op:…" consistency key
  int64_t bytes = 0;      // payload size, drives fusion bucketing
};

// Coordinator verdict for a fused batch (reference: Response, message.h:150+).
// `sigs` carries each tensor's frontend signature so ranks that JOINed can
// reconstruct zero dummy tensors of the right shape/dtype (reference:
// Response carries tensor sizes for the same purpose, message.fbs:97-118).
struct Response {
  ResponseType type = ResponseType::OK;
  RequestType op = RequestType::ALLREDUCE;
  std::vector<std::string> names;  // execution batch, globally ordered
  std::vector<std::string> sigs;   // parallel to names
  std::vector<int64_t> sizes;      // per-tensor payload bytes, parallel to
                                   // names (reference: Response tensor_sizes,
                                   // message.fbs:97-118); feeds every rank's
                                   // response-cache replica
  std::string error_message;
  int64_t total_bytes = 0;
};

// ---------------------------------------------------------------- serialization
class Writer {
 public:
  void u8(uint8_t v) { buf_.push_back(static_cast<char>(v)); }
  void u32(uint32_t v) { append(&v, 4); }
  void i64(int64_t v) { append(&v, 8); }
  void str(const std::string& s) {
    u32(static_cast<uint32_t>(s.size()));
    buf_.append(s);
  }
  const std::string& data() const { return buf_; }

 private:
  void append(const void* p, size_t n) {
    buf_.append(reinterpret_cast<const char*>(p), n);
  }
  std::string buf_;
};

class Reader {
 public:
  explicit Reader(const std::string& s) : s_(s) {}
  uint8_t u8() { return static_cast<uint8_t>(s_[off_++]); }
  uint32_t u32() { uint32_t v; take(&v, 4); return v; }
  int64_t i64() { int64_t v; take(&v, 8); return v; }
  std::string str() {
    uint32_t n = u32();
    std::string out = s_.substr(off_, n);
    off_ += n;
    return out;
  }
  bool ok() const { return off_ <= s_.size(); }

 private:
  void take(void* p, size_t n) { memcpy(p, s_.data() + off_, n); off_ += n; }
  const std::string& s_;
  size_t off_ = 0;
};

inline void SerializeRequest(const Request& r, Writer* w) {
  w->u32(static_cast<uint32_t>(r.rank));
  w->u8(static_cast<uint8_t>(r.type));
  w->str(r.name);
  w->str(r.signature);
  w->i64(r.bytes);
}

inline Request DeserializeRequest(Reader* rd) {
  Request r;
  r.rank = static_cast<int32_t>(rd->u32());
  r.type = static_cast<RequestType>(rd->u8());
  r.name = rd->str();
  r.signature = rd->str();
  r.bytes = rd->i64();
  return r;
}

inline void SerializeResponse(const Response& r, Writer* w) {
  w->u8(static_cast<uint8_t>(r.type));
  w->u8(static_cast<uint8_t>(r.op));
  w->u32(static_cast<uint32_t>(r.names.size()));
  for (const auto& n : r.names) w->str(n);
  w->u32(static_cast<uint32_t>(r.sigs.size()));
  for (const auto& s : r.sigs) w->str(s);
  w->u32(static_cast<uint32_t>(r.sizes.size()));
  for (const auto& b : r.sizes) w->i64(b);
  w->str(r.error_message);
  w->i64(r.total_bytes);
}

inline Response DeserializeResponse(Reader* rd) {
  Response r;
  r.type = static_cast<ResponseType>(rd->u8());
  r.op = static_cast<RequestType>(rd->u8());
  uint32_t n = rd->u32();
  r.names.reserve(n);
  for (uint32_t i = 0; i < n; i++) r.names.push_back(rd->str());
  uint32_t m = rd->u32();
  r.sigs.reserve(m);
  for (uint32_t i = 0; i < m; i++) r.sigs.push_back(rd->str());
  uint32_t k = rd->u32();
  r.sizes.reserve(k);
  for (uint32_t i = 0; i < k; i++) r.sizes.push_back(rd->i64());
  r.error_message = rd->str();
  r.total_bytes = rd->i64();
  return r;
}

}  // namespace hvdtpu

// Runtime flags registry.
//
// Native equivalent of the reference's exported-flags system
// (Paddle's paddle/phi/core/flags.cc:34 PADDLE_DEFINE_EXPORTED_*,
// python surface paddle.set_flags/get_flags, framework.py:7736): a
// process-wide string map seeded from FLAGS_* environment variables, with
// typed readback. Host-side config (allocator strategy, log levels,
// nan-inf checks) reads through this, matching the FLAGS_ env protocol.

#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>

extern "C" char** environ;

namespace {
std::map<std::string, std::string>& flag_map() {
  static std::map<std::string, std::string>* m = [] {
    auto* mm = new std::map<std::string, std::string>();
    for (char** e = environ; *e; ++e) {
      const char* s = *e;
      if (strncmp(s, "FLAGS_", 6) == 0) {
        const char* eq = strchr(s, '=');
        if (eq) {
          (*mm)[std::string(s + 6, eq - s - 6)] = std::string(eq + 1);
        }
      }
    }
    return mm;
  }();
  return *m;
}
std::mutex mu;
std::string last_result;
}  // namespace

extern "C" {

void pt_flags_set(const char* name, const char* value) {
  std::lock_guard<std::mutex> g(mu);
  flag_map()[name] = value;
}

// returns nullptr when unset
const char* pt_flags_get(const char* name) {
  std::lock_guard<std::mutex> g(mu);
  auto it = flag_map().find(name);
  if (it == flag_map().end()) return nullptr;
  last_result = it->second;
  return last_result.c_str();
}

int pt_flags_has(const char* name) {
  std::lock_guard<std::mutex> g(mu);
  return flag_map().count(name) ? 1 : 0;
}

// newline-joined "name=value" list
const char* pt_flags_list() {
  std::lock_guard<std::mutex> g(mu);
  last_result.clear();
  for (auto& kv : flag_map()) {
    last_result += kv.first;
    last_result += '=';
    last_result += kv.second;
    last_result += '\n';
  }
  return last_result.c_str();
}

}  // extern "C"

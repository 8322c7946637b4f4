// Native n-gram reward scorer for self-critical training: the port's copy
// of the JAX package's csrc/ngram_rewards.cpp, the same code under this
// header.
//
// The RL step's host-side cost is per-batch CIDEr-D + BLEU-4 over decoded
// strings (the reference scores them in Python every step,
// core/TRANSFORMER/loss.py:157-187).  This module reproduces the Python
// scorers in image_caption_tpu_torch/metrics/{cider,bleu}.py for the
// one-hypothesis/one-reference batch case and is loaded through ctypes
// (image_caption_tpu_torch/utils/native.py); the Python scorers remain the
// oracle and the fallback.
//
// Build: ops/_build.py compiles it with g++ at first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int kN = 4;            // n-gram orders 1..4
constexpr double kSigma = 6.0;   // CIDEr-D length-penalty sigma
constexpr double kSmall = 1e-9;  // BLEU smoothing (bleu.py SMALL)
constexpr double kTiny = 1e-15;  // BLEU smoothing (bleu.py TINY)

// FNV-1a 64-bit over the n-gram's words joined with 0x1f.
inline uint64_t fnv1a(const std::string& s) {
  uint64_t h = 1469598103934665603ull;
  for (unsigned char c : s) {
    h ^= c;
    h *= 1099511628211ull;
  }
  return h;
}

std::vector<std::string> split_ws(const char* s) {
  std::vector<std::string> out;
  std::string cur;
  for (const char* p = s; *p; ++p) {
    if (*p == ' ' || *p == '\t' || *p == '\n') {
      if (!cur.empty()) { out.push_back(cur); cur.clear(); }
    } else {
      cur.push_back(*p);
    }
  }
  if (!cur.empty()) out.push_back(cur);
  return out;
}

struct NgramCounts {
  // per order: hash -> count
  std::unordered_map<uint64_t, int> counts[kN];
  int length = 0;  // unigram count
};

NgramCounts precook(const std::vector<std::string>& words) {
  NgramCounts nc;
  nc.length = static_cast<int>(words.size());
  for (int k = 1; k <= kN; ++k) {
    for (int i = 0; i + k <= static_cast<int>(words.size()); ++i) {
      std::string key;
      for (int j = 0; j < k; ++j) {
        if (j) key.push_back('\x1f');
        key += words[i + j];
      }
      nc.counts[k - 1][fnv1a(key)] += 1;
    }
  }
  return nc;
}

struct DF {
  const uint64_t* hashes = nullptr;
  const double* values = nullptr;
  long size = 0;
  std::unordered_map<uint64_t, double> table;   // built from arrays or corpus
  double log_ref_len = 0.0;

  double get(uint64_t h) const {
    auto it = table.find(h);
    return it == table.end() ? 0.0 : it->second;
  }
};

struct TfIdfVec {
  std::unordered_map<uint64_t, double> vec[kN];
  double norm[kN] = {0, 0, 0, 0};
  int length = 0;
};

TfIdfVec counts2vec(const NgramCounts& nc, const DF& df) {
  TfIdfVec v;
  v.length = nc.length;
  for (int k = 0; k < kN; ++k) {
    for (const auto& [h, tf] : nc.counts[k]) {
      double dfv = std::log(std::max(1.0, df.get(h)));
      double val = static_cast<double>(tf) * (df.log_ref_len - dfv);
      v.vec[k][h] = val;
      v.norm[k] += val * val;
    }
    v.norm[k] = std::sqrt(v.norm[k]);
  }
  return v;
}

// cider.py _sim: per-order cosine, optional count clipping + length gaussian.
double sim_sum(const TfIdfVec& h, const TfIdfVec& r, bool clip,
               bool length_penalty) {
  double delta = static_cast<double>(h.length - r.length);
  double total = 0.0;
  for (int k = 0; k < kN; ++k) {
    double val = 0.0;
    for (const auto& [g, hv] : h.vec[k]) {
      auto it = r.vec[k].find(g);
      if (it == r.vec[k].end()) continue;
      double rv = it->second;
      double hh = clip ? std::min(hv, rv) : hv;
      val += hh * rv;
    }
    if (h.norm[k] != 0.0 && r.norm[k] != 0.0) val /= h.norm[k] * r.norm[k];
    if (length_penalty)
      val *= std::exp(-(delta * delta) / (2.0 * kSigma * kSigma));
    total += val;
  }
  return total;
}

// bleu.py per-sentence BLEU-4 (single reference, own brevity penalty).
double bleu4_sentence(const std::vector<std::string>& hyp,
                      const std::vector<std::string>& ref) {
  NgramCounts hc = precook(hyp);
  NgramCounts rc = precook(ref);
  double logbleu = 0.0;
  double result = 0.0;
  for (int k = 0; k < kN; ++k) {
    long correct = 0;
    for (const auto& [g, c] : hc.counts[k]) {
      auto it = rc.counts[k].find(g);
      if (it != rc.counts[k].end())
        correct += std::min(c, it->second);
    }
    long guess = std::max(0L, static_cast<long>(hyp.size()) - k);
    logbleu += std::log(kTiny + static_cast<double>(correct)) -
               std::log(kSmall + static_cast<double>(guess));
    if (k == kN - 1) result = std::exp(logbleu / kN);
  }
  double ratio = (static_cast<double>(hyp.size()) + kTiny) /
                 (static_cast<double>(ref.size()) + kSmall);
  if (ratio < 1.0) result *= std::exp(1.0 - 1.0 / ratio);
  return result;
}

void build_df(DF& df, const uint64_t* hashes, const double* values,
              long size, double log_ref_len,
              const std::vector<NgramCounts>* gts_counts) {
  if (size > 0) {
    df.table.reserve(static_cast<size_t>(size));
    for (long i = 0; i < size; ++i) df.table.emplace(hashes[i], values[i]);
    df.log_ref_len = log_ref_len;
  } else if (gts_counts != nullptr) {
    // corpus mode over this batch's references (cider.py _compute_corpus_df)
    for (const auto& nc : *gts_counts) {
      std::unordered_set<uint64_t> seen;
      for (int k = 0; k < kN; ++k)
        for (const auto& [g, _] : nc.counts[k]) seen.insert(g);
      for (uint64_t g : seen) df.table[g] += 1.0;
    }
    df.log_ref_len =
        std::log(std::max(static_cast<double>(gts_counts->size()), 1e-12));
  } else {
    df.log_ref_len = log_ref_len;
  }
}

// Shared per-pair scoring loop over pre-split/pre-cooked sentences.
void score_pairs(const DF& df,
                 const std::vector<std::vector<std::string>>& res_words,
                 const std::vector<std::vector<std::string>>& gts_words,
                 const std::vector<NgramCounts>& res_counts,
                 const std::vector<NgramCounts>& gts_counts,
                 double cider_w, double bleu_w, float* out) {
  int n = static_cast<int>(res_words.size());
  for (int i = 0; i < n; ++i) {
    double score = 0.0;
    if (cider_w != 0.0) {
      TfIdfVec vh = counts2vec(res_counts[i], df);
      TfIdfVec vr = counts2vec(gts_counts[i], df);
      // mean over orders / 1 ref * 10 (cider.py _score_all)
      double ciderd = sim_sum(vh, vr, /*clip=*/true,
                              /*length_penalty=*/true) / kN * 10.0;
      score += cider_w * ciderd;
    }
    if (bleu_w != 0.0)
      score += bleu_w * bleu4_sentence(res_words[i], gts_words[i]);
    out[i] = static_cast<float>(score);
  }
}

void cook_pairs(const char** res, const char** gts, int n,
                std::vector<std::vector<std::string>>& res_words,
                std::vector<std::vector<std::string>>& gts_words,
                std::vector<NgramCounts>& res_counts,
                std::vector<NgramCounts>& gts_counts) {
  res_words.resize(n); gts_words.resize(n);
  res_counts.resize(n); gts_counts.resize(n);
  for (int i = 0; i < n; ++i) {
    res_words[i] = split_ws(res[i]);
    gts_words[i] = split_ws(gts[i]);
    res_counts[i] = precook(res_words[i]);
    gts_counts[i] = precook(gts_words[i]);
  }
}

}  // namespace

extern "C" {

// Persistent frozen-df handle.  Rebuilding the df hash map per call was
// the RL step's dominant host cost (~35 ms/call at a 1024-image df —
// the COCO table is 40x larger): the table is immutable across a
// training run, so callers with a frozen df build it ONCE here and score
// through icx_structure_scores_df.  The handle-free entry points below
// stay for corpus-mode scoring (the df genuinely is per-batch there) and
// for oracle tests.
void* icx_df_create(const uint64_t* df_hashes, const double* df_values,
                    long df_size, double log_ref_len) {
  DF* df = new DF();
  build_df(*df, df_hashes, df_values, df_size, log_ref_len, nullptr);
  return df;
}

void icx_df_destroy(void* handle) { delete static_cast<DF*>(handle); }

// Per-sentence structure scores against a prebuilt frozen-df handle.
void icx_structure_scores_df(const void* handle, const char** res,
                             const char** gts, int n, double cider_w,
                             double bleu_w, float* out) {
  std::vector<std::vector<std::string>> res_words, gts_words;
  std::vector<NgramCounts> res_counts, gts_counts;
  cook_pairs(res, gts, n, res_words, gts_words, res_counts, gts_counts);
  score_pairs(*static_cast<const DF*>(handle), res_words, gts_words,
              res_counts, gts_counts, cider_w, bleu_w, out);
}

// Per-sentence structure scores: cider_w * CIDEr-D(res_i, gts_i) +
// bleu_w * BLEU-4(res_i, gts_i).  df_size == 0 -> corpus-mode df over the
// batch's references (the Python fallback); otherwise the frozen table
// (rebuilt per call — prefer icx_df_create + icx_structure_scores_df on
// hot paths).
void icx_structure_scores(const char** res, const char** gts, int n,
                          double cider_w, double bleu_w,
                          const uint64_t* df_hashes, const double* df_values,
                          long df_size, double log_ref_len, float* out) {
  std::vector<std::vector<std::string>> res_words, gts_words;
  std::vector<NgramCounts> res_counts, gts_counts;
  cook_pairs(res, gts, n, res_words, gts_words, res_counts, gts_counts);

  DF df;
  build_df(df, df_hashes, df_values, df_size, log_ref_len, &gts_counts);
  score_pairs(df, res_words, gts_words, res_counts, gts_counts,
              cider_w, bleu_w, out);
}

// Per-sentence self-CIDEr diversity (loss.py:189-216 single-sample case):
// gram = sum_k sim(v, v) with no clip/penalty; get_div of eigvals(gram/10).
void icx_self_cider_scores(const char** res, int n,
                           const uint64_t* df_hashes, const double* df_values,
                           long df_size, double log_ref_len, float* out) {
  DF df;
  build_df(df, df_hashes, df_values, df_size,
           df_size > 0 ? log_ref_len : 0.0, nullptr);
  for (int i = 0; i < n; ++i) {
    NgramCounts nc = precook(split_ws(res[i]));
    TfIdfVec v = counts2vec(nc, df);
    double gram = sim_sum(v, v, /*clip=*/false, /*length_penalty=*/false);
    double eig = gram / 10.0;             // 1x1 matrix eigenvalue
    if (eig <= 0.0) { out[i] = 0.0f; continue; }
    double sqrt_top = std::sqrt(eig);
    double sqrt_sum = sqrt_top;           // single eigenvalue
    double log_n = 1e-8;                  // log(1) -> epsilon (rewards.py)
    out[i] = static_cast<float>(-std::log(sqrt_top / sqrt_sum) / log_n);
  }
}

}  // extern "C"

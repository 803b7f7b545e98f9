// The owner view of an interval-sharded index, as every entry point of
// sharded.cu and sharded_partial.cu takes it.
#pragma once

#include <cstdint>

namespace rs {

// The owner view; ops/sharded.py's ShardView mirrors it field for field
// (every field 8 bytes, a missing table null).  Strides are in elements of
// the table's type (uint32 words, int32 entries, int32 pairs).
struct ShardView {
  long long S, n, num_reads, log2_block, words_per_block, row_words,
      rows_per_symbol, sample_rate, max_read_len, dsa_bits;
  const long long* starts;  // [S] position ranges
  const long long* lens;
  const long long* C;   // [6]
  const long long* C2;  // [16]
  const long long* C3;  // [64]
  const uint32_t* rank;
  long long rank_stride;
  const long long* rank_prefix;  // [S + 1, 5]
  const uint32_t* rank2;
  long long rank2_stride;
  const long long* rank2_prefix;  // [S + 1, 16]
  const uint32_t* rank3;
  long long rank3_stride;
  const long long* rank3_prefix;  // [S + 1, 64]
  const uint32_t* sym4;
  long long sym4_stride;
  const int32_t* dollar;  // $-rank ranges
  long long dollar_stride;
  const long long* dstarts;
  const long long* dlens;
  const int32_t* sample;  // read-id ranges
  long long sample_stride;
  const long long* rstarts;
  const long long* rlens;
  const uint32_t* dsa;
  long long dsa_stride;
  const int32_t* lf;
  long long lf_stride;
  const uint32_t* marks;
  long long marks_stride;
  const long long* mark_prefix;  // [S + 1]
  const int32_t* spairs;         // mark-rank ranges, pairs (read id, offset)
  long long spairs_stride;
  const long long* sstarts;
  const long long* slens;
};

}  // namespace rs

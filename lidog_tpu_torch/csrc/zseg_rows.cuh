// The zseg plan's column-table rows, shared by the column tables
// (zseg_tables.cu: KV-KY) and the query sweeps (zseg_sweeps.cu: KR-KU).
// core/zseg.py states the same layout (ZWORDS, REAL_W), and its wrappers
// check every table they pass against it.
//
//   real16 [slots, REAL_W]: the ZWORDS z-bit words (uint32 values read as
//          int32), then 2 zero pad words; 64 bytes a slot (lidog_tpu's).
//   aug16  [slots, AUG16]: the ZWORDS aug words, the GLOBAL start row and
//          the count; 64 bytes a slot.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int ZWORDS = 14;
constexpr int ZC = ZWORDS * 16;
constexpr int ZMAX = ZWORDS * 32;
constexpr int AUG16 = ZWORDS + 2;  // aug16 row: words + start + count
constexpr int REAL_W = 16;         // real16 row: words + 2 zero pad words

// Stage 16-byte quarter c (words 4c .. 4c+3) of slot u's real16 row into
// dst[4c ..]: zeros for a slot outside [0, slots); the pad words 14 and
// 15 are not written, so dst needs only ZWORDS words.
__device__ __forceinline__ void stage_real16(unsigned* dst, const int4* __restrict__ real4, int u,
                                             int slots, int c) {
  int4 v = make_int4(0, 0, 0, 0);
  if (u >= 0 && u < slots) v = real4[u * (REAL_W / 4) + c];
  dst += 4 * c;
  dst[0] = (unsigned)v.x;
  dst[1] = (unsigned)v.y;
  if (c < 3) {
    dst[2] = (unsigned)v.z;
    dst[3] = (unsigned)v.w;
  }
}

}  // namespace

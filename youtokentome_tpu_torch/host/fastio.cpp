// Native host helpers for the hot byte-wrangling paths the device can't
// cover (TPU-native equivalent of the reference's C++ CLI stream loops,
// bpe.cpp:1942-2028: stdout id formatting, file slurping).  Compiled on
// demand into _fastio.so and loaded via ctypes; every entry point has a
// pure-Python fallback in fastio.py.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Format a flat id stream as the reference CLI does (utils.h:92-103):
// every token is written as decimal followed by one space; the sentinel
// token ends the line with '\n'.  Returns bytes written.  `out` must
// hold at least 12 * n + 1 bytes.
long yttm_format_ids(const int32_t *ids, long n, int32_t sentinel, char *out) {
  char *p = out;
  for (long i = 0; i < n; i++) {
    int32_t v = ids[i];
    if (v == sentinel) {
      *p++ = '\n';
      continue;
    }
    if (v < 0) {
      *p++ = '-';
      v = -v;
    }
    char tmp[12];
    int k = 0;
    do {
      tmp[k++] = '0' + (v % 10);
      v /= 10;
    } while (v);
    while (k) *p++ = tmp[--k];
    *p++ = ' ';
  }
  return p - out;
}

// Same for a uint16 wire-format stream (0xFFFF = sentinel).
long yttm_format_ids_u16(const uint16_t *ids, long n, char *out) {
  char *p = out;
  for (long i = 0; i < n; i++) {
    uint32_t v = ids[i];
    if (v == 0xFFFFu) {
      *p++ = '\n';
      continue;
    }
    char tmp[8];
    int k = 0;
    do {
      tmp[k++] = '0' + (v % 10);
      v /= 10;
    } while (v);
    while (k) *p++ = tmp[--k];
    *p++ = ' ';
  }
  return p - out;
}

// Parse whitespace-separated decimal ids (the decode CLI input path,
// bpe.cpp:1863-1882); newline emits the sentinel.  Returns count.
long yttm_parse_ids(const char *text, long n, int32_t sentinel, int32_t *out) {
  long m = 0;
  long i = 0;
  while (i < n) {
    char c = text[i];
    if (c == '\n') {
      out[m++] = sentinel;
      i++;
    } else if (c == '-' || (c >= '0' && c <= '9')) {
      int neg = c == '-';
      if (neg) i++;
      int64_t v = 0;
      while (i < n && text[i] >= '0' && text[i] <= '9') {
        v = v * 10 + (text[i] - '0');
        i++;
      }
      out[m++] = (int32_t)(neg ? -v : v);
    } else {
      i++;
    }
  }
  return m;
}

}  // extern "C"

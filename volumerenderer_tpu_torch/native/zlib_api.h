// zlib_api.h — the zlib calls of this library.
//
// The system's <zlib.h> when the compiler finds one.  Without it (a
// machine with the zlib runtime but not its development files), the
// declarations of the five functions and the constants these sources use,
// as zlib 1.2's ABI defines them; grid/vdbio_native.py then links the
// runtime library by its path.
#pragma once

#if __has_include(<zlib.h>)
#include <zlib.h>
#else
extern "C" {
typedef unsigned char Bytef;
typedef unsigned int uInt;
typedef unsigned long uLong;
typedef uLong uLongf;
int compress(Bytef* dest, uLongf* destLen, const Bytef* source,
             uLong sourceLen);
int compress2(Bytef* dest, uLongf* destLen, const Bytef* source,
              uLong sourceLen, int level);
uLong compressBound(uLong sourceLen);
int uncompress(Bytef* dest, uLongf* destLen, const Bytef* source,
               uLong sourceLen);
uLong crc32(uLong crc, const Bytef* buf, uInt len);
}
#define Z_OK 0
#define Z_DEFAULT_COMPRESSION (-1)
#endif

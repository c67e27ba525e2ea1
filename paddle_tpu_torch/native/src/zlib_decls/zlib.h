// The zlib entry points native.cc uses, declared for a machine that has
// the zlib runtime (libz.so.1) but not its development header. The build
// (native/__init__.py) puts this directory on the include path only when
// <zlib.h> is missing, and then links libz.so.1 by its file name.
// Declarations as zlib 1.2 / 1.3 export them (zlib.h, zconf.h).
#ifndef PTNATIVE_ZLIB_DECLS_H
#define PTNATIVE_ZLIB_DECLS_H

typedef unsigned char Byte;
typedef Byte Bytef;
typedef unsigned int uInt;
typedef unsigned long uLong;
typedef uLong uLongf;
typedef struct gzFile_s* gzFile;

#define Z_OK 0
#define Z_STREAM_END 1
#define Z_DEFAULT_COMPRESSION (-1)

extern "C" {
uLong compressBound(uLong sourceLen);
int compress2(Bytef* dest, uLongf* destLen, const Bytef* source, uLong sourceLen,
              int level);
int uncompress(Bytef* dest, uLongf* destLen, const Bytef* source, uLong sourceLen);
uLong crc32(uLong crc, const Bytef* buf, uInt len);
gzFile gzopen(const char* path, const char* mode);
char* gzgets(gzFile file, char* buf, int len);
const char* gzerror(gzFile file, int* errnum);
int gzclose(gzFile file);
}

#endif  // PTNATIVE_ZLIB_DECLS_H

/* Minimal self-declared Win32 API subset so the _WIN32 branch of
 * beamformer_lib.c can be syntax/type-checked on a Linux box without a
 * Windows SDK (there is no mingw in this toolchain):
 *
 *   cc -fsyntax-only -std=c11 -D_WIN32 -DBF_WIN32_SYNTAX_CHECK beamformer_lib.c
 *
 * Signatures mirror <windows.h> / <synchapi.h> / <memoryapi.h> for exactly
 * the calls the platform layer uses.  NOT used in real Windows builds —
 * those include <windows.h> (see beamformer_lib.c).
 */
#ifndef BF_WIN32_CHECK_H
#define BF_WIN32_CHECK_H

#include <stddef.h>
#include <stdint.h>

typedef void         *HANDLE;
typedef int           BOOL;
typedef unsigned long DWORD;
typedef uint64_t      ULONGLONG;
typedef size_t        SIZE_T;
typedef void         *LPVOID;
typedef const void   *LPCVOID;
typedef const char   *LPCSTR;

typedef struct {
	void  *BaseAddress;
	void  *AllocationBase;
	DWORD  AllocationProtect;
	SIZE_T RegionSize;
	DWORD  State;
	DWORD  Protect;
	DWORD  Type;
} MEMORY_BASIC_INFORMATION;

#define INVALID_HANDLE_VALUE ((HANDLE)(intptr_t)-1)
#define PAGE_READWRITE       0x04
#define FILE_MAP_ALL_ACCESS  0x000F001F
#define INFINITE             0xFFFFFFFFu
#define MEM_FREE             0x10000

BOOL   WaitOnAddress(volatile void *Address, void *CompareAddress,
                     SIZE_T AddressSize, DWORD dwMilliseconds);
void   WakeByAddressSingle(void *Address);
void   WakeByAddressAll(void *Address);
HANDLE OpenFileMappingA(DWORD dwDesiredAccess, BOOL bInheritHandle,
                        LPCSTR lpName);
HANDLE CreateFileMappingA(HANDLE hFile, void *lpAttributes, DWORD flProtect,
                          DWORD dwMaximumSizeHigh, DWORD dwMaximumSizeLow,
                          LPCSTR lpName);
LPVOID MapViewOfFile(HANDLE hFileMappingObject, DWORD dwDesiredAccess,
                     DWORD dwFileOffsetHigh, DWORD dwFileOffsetLow,
                     SIZE_T dwNumberOfBytesToMap);
BOOL   UnmapViewOfFile(LPCVOID lpBaseAddress);
BOOL   CloseHandle(HANDLE hObject);
SIZE_T VirtualQuery(LPCVOID lpAddress, MEMORY_BASIC_INFORMATION *lpBuffer,
                    SIZE_T dwLength);
ULONGLONG GetTickCount64(void);
DWORD  GetLastError(void);

#define ERROR_ALREADY_EXISTS 183

#endif /* BF_WIN32_CHECK_H */

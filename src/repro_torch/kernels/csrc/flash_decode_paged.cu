// Flash-decode's block-table mode (paged KV cache): the PAGED
// instantiations of flash_decode.cu and their entry point,
// flash_decode_paged_forward, built as a library of their own so that the
// two modes compile in parallel.  The kernel, its design and what bounds
// it are described in flash_decode.cu.
#define FD_PAGED 1
#include "flash_decode.cu"

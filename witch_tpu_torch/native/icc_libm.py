"""Optional exact-libm provider for the f32 reporting-gate chain.

The reference's bundled hmmsearch is icc-compiled; its profile scores
pass through icc's libm (expf.L, logf.L, log.L, __svml_logf4.L), which
differs from glibc's correctly-rounded functions on ~0.1-0.7% of inputs
(1-ulp).  Those last-ulp differences are exactly where the binary's
marginal reporting decisions live, so for bit-exact gate parity this
module maps the oracle binary's PT_LOAD segments into the current
process (the binary is non-PIE: fixed vaddrs around 0x400000, far below
any PIE mapping) and hands the .L entry addresses to the native engine
(_domaindef.set_icc_libm).

This is runtime interop with the installed oracle binary — the same
binary the reference itself executes — not a code dependency. The
binary's path comes from WITCH_TPU_ICC_LIBM; without it (or when the
file is absent) the engine uses glibc and stays within 1 ulp
everywhere.

Safety: segments are mapped with MAP_FIXED_NOREPLACE, so an (extremely
unlikely) address collision aborts the load instead of clobbering
mappings; every failure path degrades to the glibc chain.
"""

from __future__ import annotations

import ctypes
import os
import struct

_WANTED = ("expf.L", "logf.L", "log.L", "__svml_logf4.L")

_loaded: dict = {}


def _read_symbols(data: bytes, wanted=_WANTED) -> dict:
    """Minimal ELF64 symtab reader: name -> st_value (all symbols when
    wanted is None)."""
    (e_shoff,) = struct.unpack_from("<Q", data, 0x28)
    (e_shentsize, e_shnum) = struct.unpack_from("<HH", data, 0x3A)
    sections = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        sh_type, = struct.unpack_from("<I", data, off + 4)
        sh_offset, sh_size = struct.unpack_from("<QQ", data, off + 0x18)
        sh_link, = struct.unpack_from("<I", data, off + 0x28)
        sh_entsize, = struct.unpack_from("<Q", data, off + 0x38)
        sections.append((sh_type, sh_offset, sh_size, sh_link, sh_entsize))
    out = {}
    for sh_type, off, size, link, entsize in sections:
        if sh_type != 2 or not entsize:     # SHT_SYMTAB
            continue
        _, stroff, strsize, _, _ = sections[link]
        strtab = data[stroff:stroff + strsize]
        for so in range(off, off + size, entsize):
            st_name, = struct.unpack_from("<I", data, so)
            if not st_name:
                continue
            end = strtab.index(b"\x00", st_name)
            name = strtab[st_name:end].decode("latin-1")
            if wanted is None or name in wanted:
                st_value, = struct.unpack_from("<Q", data, so + 8)
                out[name] = st_value
    return out


def load(path: str = None) -> dict:
    """Map the oracle binary and return {sym: address}; {} on any
    failure.  Idempotent per path."""
    env = os.environ.get("WITCH_TPU_ICC_LIBM")
    path = path or env
    if not path or path == "0":
        return {}
    if path in _loaded:
        return _loaded[path]
    _loaded[path] = {}
    try:
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"\x7fELF" or data[4] != 2 or data[0x12] != 0x3e:
            return {}
        e_type, = struct.unpack_from("<H", data, 0x10)
        if e_type != 2:                      # ET_EXEC (fixed vaddrs) only
            return {}
        syms = _read_symbols(data)
        if set(_WANTED) - set(syms):
            return {}
        e_phoff, = struct.unpack_from("<Q", data, 0x20)
        e_phentsize, = struct.unpack_from("<H", data, 0x36)
        e_phnum, = struct.unpack_from("<H", data, 0x38)
        libc = ctypes.CDLL(None, use_errno=True)
        libc.mmap.restype = ctypes.c_void_p
        libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_long]
        PAGE = 4096
        PROT_RWX = 0x7
        MAP_PRIVATE, MAP_ANON = 0x2, 0x20
        MAP_FIXED_NOREPLACE = 0x100000
        mapped = []
        for i in range(e_phnum):
            off = e_phoff + i * e_phentsize
            p_type, = struct.unpack_from("<I", data, off)
            if p_type != 1:                  # PT_LOAD
                continue
            p_offset, p_vaddr, _, p_filesz, p_memsz = struct.unpack_from(
                "<QQQQQ", data, off + 8)
            start = p_vaddr & ~(PAGE - 1)
            end = (p_vaddr + p_memsz + PAGE - 1) & ~(PAGE - 1)
            r = libc.mmap(ctypes.c_void_p(start), end - start, PROT_RWX,
                          MAP_PRIVATE | MAP_ANON | MAP_FIXED_NOREPLACE,
                          -1, 0)
            if r != start:
                # collision or denied: unmap what we placed and bail
                for s, ln in mapped:
                    libc.munmap(ctypes.c_void_p(s), ln)
                return {}
            mapped.append((start, end - start))
            ctypes.memmove(p_vaddr, data[p_offset:p_offset + p_filesz],
                           p_filesz)
        _loaded[path] = {k: v for k, v in syms.items()}
        return _loaded[path]
    except Exception:
        return {}


def install(_domaindef, path: str = None) -> bool:
    """Load the oracle libm and hand the addresses to the engine."""
    if not hasattr(_domaindef, "set_icc_libm"):
        return False
    syms = load(path)
    if not syms:
        return False
    _domaindef.set_icc_libm(syms["expf.L"], syms["logf.L"],
                            syms["log.L"], syms["__svml_logf4.L"])
    return True

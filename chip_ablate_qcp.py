#!/usr/bin/env python3
"""Ablation of the all-pairs QCP kernel of enspara_tpu_torch (kernel 5,
``enspara_tpu_torch/csrc/qcp_matrix.cu``) on one GPU.

Run from the root of a checkout, with one CUDA card visible:

    python3 chip_ablate_qcp.py

Each variant is the shipped source with one design choice undone by a
text edit, built as its own library under ``build/qcp_ablation/`` (one
``nvcc -Xptxas -v`` each, all started together; the registers and
spills are printed), then timed at two of ``chip_smoke.py``'s phase-4
shapes, a 1,048,576 x 256 x 64 assignment block and a 131,072 x 64 x 64
PAM block: three rounds of CUDA events around 10 and 50 launches, and
the largest difference from the shipped kernel's output. The variants:

- ``shipped``;
- ``no_epilogue``: the Newton epilogue replaced by the magnitude of the
  sum of the nine S components, no pair flagged for the finish pass, so
  the time is the contraction's, the staging's and the finish pass's
  read of the block;
- ``one_pass``: hi x hi alone instead of the three 3xTF32 passes
  (wrong by design; the difference is the tensor-core time of two
  passes);
- ``no_turns``: the token barriers removed, so the two warp groups of a
  block contract and run their epilogues when they like (a group
  barrier takes the token's place before each tile, the fence between
  the last reads of the ring and the next tile's copies);
- ``cvt``: the ``cvt.rna.tf32.f32`` instruction instead of its integer
  form (the same bits);
- ``chunk8``: 8 atoms a stage instead of 16.

It times kernels only; ``chip_smoke.py`` holds the shipped kernel to its
plain version.
"""

import ctypes
import os
import re
import subprocess
import sys

import torch

from enspara_tpu_torch.ops import _build, qcp_matrix

CSRC = _build.CSRC_DIR
OUT = os.path.join('build', 'qcp_ablation')
SOURCES = ('qcp_matrix.cu', 'mma_tf32.cuh', 'qcp_rmsd.cuh')
SHAPES = ((1_048_576, 256, 64, 10), (131_072, 64, 64, 50))
ROUNDS = 3

NO_EPILOGUE = [('d[e2] = qcp_rmsd_flagged(S, gfr[h] + (e2 ? gcv.y : gcv.x), '
                'n_atoms,\n                                 near);',
                'd[e2] = fabsf(S[0] + S[1] + S[2] + S[3] + S[4] + S[5] + '
                'S[6] + S[7] + S[8]);\n        near = false;')]
ONE_PASS = [('mma_tf32(acc[3 * i + j][nt], a_lo, b_hi[j][nt]);', ';'),
            ('mma_tf32(acc[3 * i + j][nt], a_hi, b_lo[j][nt]);', ';')]
NO_TURNS = [('bar_sync(kTokenBar + group, kThreads);',
             'bar_sync(kRingBar + group, kGroupThreads);'),
            ('bar_arrive(kTokenBar + 1 - group, kThreads);', ';'),
            ('bar_sync(kTokenBar, kThreads);', ';')]
CVT = [('  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;',
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));'
        '\n  return r;')]
CHUNK8 = [('constexpr int kChunkA = 16;', 'constexpr int kChunkA = 8;')]
VARIANTS = {'shipped': [], 'no_epilogue': NO_EPILOGUE, 'one_pass': ONE_PASS,
            'no_turns': NO_TURNS, 'cvt': CVT, 'chunk8': CHUNK8}


def write_variant(name, edits):
    """The sources of one variant under OUT/name; raises unless every
    edit's text is found in a source."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    texts = {}
    for f in SOURCES:
        with open(os.path.join(CSRC, f)) as fh:
            texts[f] = fh.read()
    for old, new in edits:
        hits = [f for f in SOURCES if old in texts[f]]
        if not hits:
            raise RuntimeError('%s: %r is not in the sources' % (name, old))
        for f in hits:
            texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        with open(os.path.join(d, f), 'w') as fh:
            fh.write(text)
    return d


def build_all():
    """Build every variant in parallel; returns {name: ctypes library}."""
    nvcc = _build.find_nvcc()
    jobs = {}
    for name, edits in VARIANTS.items():
        d = write_variant(name, edits)
        jobs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, '-Xptxas', '-v', '-o',
             os.path.join(d, 'lib.so'), os.path.join(d, 'qcp_matrix.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed for %s:\n%s' % (name, out[-3000:]))
        print('%-12s %s' % (name, '; '.join(re.findall(
            r'Used \d+ registers|\d+ bytes spill stores', out))), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name, 'lib.so'))
        p = ctypes.c_void_p
        lib.qcp_matrix.argtypes = [p, p, ctypes.c_longlong, p, p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                   p, p]
        lib.qcp_matrix.restype = ctypes.c_int
        libs[name] = lib
    return libs


def events_ms(fn, reps):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_ablate_qcp.py needs a CUDA card')
    card = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print('card:', card, flush=True)
    libs = build_all()
    dev = torch.device('cuda')
    stream = torch.cuda.current_stream(dev).cuda_stream
    for F, C, A, reps in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        X = torch.randn((F, A, 3), generator=gen, device=dev)
        Y = X[torch.randint(0, F, (C,), generator=gen, device=dev)] \
            + 0.01 * torch.randn((C, A, 3), generator=gen, device=dev)
        X = X - X.mean(dim=1, keepdim=True)
        Y = Y - Y.mean(dim=1, keepdim=True)
        fr, gf = qcp_matrix.to_layout(X, F, A)
        cr, gc = qcp_matrix.to_layout(Y, C, A)
        del X, Y
        ref = qcp_matrix.qcp_rmsd_matrix_kernel(fr, gf, cr, gc, A)
        out = torch.empty_like(ref)
        args = [ctypes.c_void_p(t.data_ptr()) for t in (fr, gf)] + [F] + [
            ctypes.c_void_p(t.data_ptr()) for t in (cr, gc)] + [
            C, A, float(A), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(stream)]
        for name, lib in libs.items():
            def call():
                err = lib.qcp_matrix(*args)
                if err:
                    raise RuntimeError('%s: launch failed (%d)' % (name, err))
            call()
            ms = [events_ms(call, reps) for _ in range(ROUNDS)]
            print('[%s] %d x %d x %d %-12s ms per block %s; max |variant - '
                  'shipped| %.3g' % (card, F, C, A, name,
                                     ' '.join('%.4f' % t for t in ms),
                                     float((out - ref).abs().max())),
                  flush=True)
        del fr, gf, cr, gc, ref, out
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()

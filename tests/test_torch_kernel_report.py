"""The parsers of ``tools/kernel_report.py`` on the forms nvcc's
``-Xptxas -v`` and ``cuobjdump --dump-sass`` print (the tool itself needs the
CUDA toolkit)."""

from pointdsc_tpu_torch.tools import kernel_report

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""

SASS = """
\tcode for sm_90a
\t\tFunction : _Z1av
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0a30*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;
        /*0a40*/                   HMMA.16816.F32.BF16 R8, R12, R22, R8 ;
        /*0a50*/                   FFMA R1, R2, R3, R1 ;
\t\tFunction : _Z1bv
        /*0000*/                   HMMA.1688.F32.TF32 R4, R12, R20, R4 ;
        /*0010*/                   EXIT ;
"""


def test_ptxas_report():
    info = kernel_report.ptxas_report(PTXAS)
    assert info == {"_Z1av": dict(stack=0, spill_stores=8, spill_loads=4, registers=128),
                    "_Z1bv": dict(stack=16, spill_stores=0, spill_loads=0, registers=40)}


def test_sass_hmma():
    counts = kernel_report.sass_hmma(SASS)
    assert counts == {"_Z1av": {"HMMA.16816.F32.BF16": 2}, "_Z1bv": {"HMMA.1688.F32.TF32": 1}}


def test_sass_digest():
    """One digest per kernel, blind to addresses and encodings, not to the
    instructions."""
    digest = kernel_report.sass_digest(SASS)
    assert set(digest) == {"_Z1av", "_Z1bv"}
    moved = SASS.replace("/*0a30*/", "/*1a30*/").replace("R4, R12, R20, R4 ;",
                                                         "R4, R12, R20, R4 ; /* 0x1 */")
    assert kernel_report.sass_digest(moved) == digest
    changed = SASS.replace("FFMA R1, R2, R3, R1", "FFMA R1, R2, R3, R2")
    assert kernel_report.sass_digest(changed)["_Z1av"] != digest["_Z1av"]
    assert kernel_report.sass_digest(changed)["_Z1bv"] == digest["_Z1bv"]


def test_sass_loops():
    """Each branch to a lower address is a loop of the instructions from its
    target to it, those of the regions that a forward branch skips and that
    hold a call counted as rare; forward branches and a branch to itself are
    no loops."""
    sass = """
\t\tFunction : _Z1av
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R1, R2, R3, R1 ;
        /*0020*/              @!P0 BRA P2, 0x60 ;
        /*0030*/                   MOV R4, R1 ;
        /*0040*/                   CALL.REL.NOINC 0x100 ;
        /*0050*/                   BRA 0x70 ;
        /*0060*/                   FMUL R1, R1, R1 ;
        /*0070*/              @P1 BRA 0x10 ;
        /*0080*/                   BRA.U 0x0 ;
        /*0090*/                   BRA 0xb0 ;
        /*00a0*/                   BRA 0xa0 ;
\t\tFunction : _Z1bv
        /*0000*/                   EXIT ;
"""
    assert kernel_report.sass_loops(sass) == {
        "_Z1av": [{"instructions": 9, "rare": 3}, {"instructions": 7, "rare": 3}],
        "_Z1bv": []}


def test_compare_matches_kernels_across_template_arguments():
    """A parent's kernel is matched to this tree's kernels of the same name,
    whatever their template arguments and parameters; the SASS is the same
    where one of their digests is its own."""
    assert kernel_report.base_name(
        "void (anonymous namespace)::hypotheses_kernel<(bool)0, (bool)1>(const float *)") \
        == "hypotheses_kernel"
    assert kernel_report.base_name("oa::f<1>(int)") == "f"
    assert kernel_report.base_name("void <unnamed>::g<(int)0>(const float *)") == "g"
    parent = [{"source": "a.cu", "kernel": "(anonymous namespace)::k(float *)",
               "sass_sha256": "x"},
              {"source": "a.cu", "kernel": "void (anonymous namespace)::t<false>(int)",
               "sass_sha256": "y"},
              {"source": "a.cu", "kernel": "issue floor"}]
    rows = [{"kernel": "void (anonymous namespace)::t<false, false>(int, int)",
             "sass_sha256": "y"},
            {"kernel": "void (anonymous namespace)::t<false, true>(int, int)",
             "sass_sha256": "z"},
            {"kernel": "(anonymous namespace)::k(float *, int)", "sass_sha256": "w"}]
    got = {r["compare"]: (r["same_sass"], r["this_sha256"])
           for r in kernel_report.compare(parent, rows)}
    assert got == {"k": (False, ["w"]), "t": (True, ["y", "z"])}

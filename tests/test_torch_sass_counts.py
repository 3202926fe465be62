"""bnsgcn_tpu_torch/sass_counts.py on a saved disassembly: the loop finder,
the classes and the per-vector counts (the tool itself runs where nvcc and
cuobjdump are, on the card's machine)."""

from bnsgcn_tpu_torch import sass_counts

_SASS = """
	code for sm_90a
		Function : _ZN46_GLOBAL__N__0b1c2d3e_13_bucket_sum_cu_5f6a7b8c15ell_rows_kernelIaLi16EEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   SHFL.IDX PT, R3, R2, R4, 0x1f ;
        /*0030*/              @!P0 LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;
        /*0040*/                   PRMT R12, R8, 0x5140, R9 ;
        /*0050*/                   IDP.4A.S8.S8 R20, R12, R13, R20 ;
        /*0060*/                   HADD2.F32 R14, -RZ, R8.H0_H0 ;
        /*0070*/                   LDG.E.128.CONSTANT R8, desc[UR4][R6.64] ;
        /*0080*/                   FADD R21, R21, R14 ;
        /*0090*/               @P1 BRA 0x20 ;
        /*00a0*/                   ISETP.GE.AND P0, PT, R0, 0x3, PT ;
        /*00b0*/              @!P0 BRA 0xa0 ;
        /*00c0*/                   EXIT ;
		Function : _Z5otherv
        /*0000*/                   EXIT ;
"""


def test_sass_counts_finds_the_hot_loop_and_counts_per_vector():
    fns = sass_counts.parse(_SASS)
    assert len(fns) == 2
    name = next(k for k in fns if "ell_rows" in k)
    assert sass_counts.short_name(name) == "ell_rows_kernel<signed char, 16>"
    ins = fns[name]
    assert len(ins) == 13
    # two loops, neither nested in the other: 0x20..0x90 and 0xa0..0xb0
    assert sorted(sass_counts.innermost_loops(ins)) == [(0x20, 0x90),
                                                       (0xa0, 0xb0)]
    c = sass_counts.loop_counts(ins, 0x20, 0x90)
    assert c["instructions"] == 8 and c["vector_loads"] == 2
    assert c["by_class"] == {"shfl": 1, "load": 2, "bits": 1, "int": 1,
                             "cvt": 1, "fp32": 1, "branch": 1}
    assert c["per_vector_total"] == 4.0
    assert c["per_vector"]["load"] == 1.0
    assert sass_counts.classify("UIADD3") == "uniform"
    assert sass_counts.classify("HADD2") == "fp16"

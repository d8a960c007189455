"""`utils/spills.py`'s reading of an nvdisasm listing, on made-up ones (a real
listing comes only from the CUDA toolkit)."""

from minilp_tpu_torch.utils import spills

LISTING = """
\t.text._Z6kernelv:
        //## File "/src/csrc/k.cu", line 40
        /*0090*/                   LDL R2, [R1+0x10] ;
        /*00a0*/              @!P0 STL.64 [R1+0x8], R4 ;
        //## File "/src/csrc/common.cuh", line 7 inlined at "/src/csrc/k.cu", line 12
        //## File "/src/csrc/k.cu", line 12 inlined at "/src/csrc/k.cu", line 90
        /*00b0*/                   LDL.128 R8, [R1] ;
        /*00c0*/                   LDL.128 R12, [R1+0x20] ;
        /*00d0*/                   LDG.E R3, desc[UR4][R2.64] ;
        /*00e0*/                   EXIT ;
\t.text._Z6helperv:
        //## File "/src/csrc/k.cu", line 5
        /*0000*/                   STL [R1], R2 ;
        /*0010*/                   RET.REL.NODEC R20 `(_Z6helperv) ;
"""

#: a loop at 0x10 (lines 50-51), and a block placed after the exit that
#: branches back to 0x40 without being dominated by it: no loop there
LOOPS = """
\t.text._Z4loopv:
        //## File "/src/csrc/k.cu", line 40
        /*0000*/                   LDL R2, [R1+0x10] ;
.L_x_1:
        //## File "/src/csrc/k.cu", line 50
        /*0010*/                   LDL.64 R4, [R1+0x8] ;
        /*0020*/                   CALL.REL.NOINC `($_Z4loopv$sub) ;
        //## File "/src/csrc/k.cu", line 51
        /*0030*/               @P0 BRA `(.L_x_1) ;
        /*0040*/               @P1 BRA `(.L_x_2) ;
.L_x_3:
        //## File "/src/csrc/k.cu", line 60
        /*0050*/                   STL [R1], R2 ;
        /*0060*/                   EXIT ;
.L_x_2:
        /*0070*/                   LDL R6, [R1+0x4] ;
        /*0080*/                   BRA `(.L_x_3) ;
$_Z4loopv$sub:
.L_x_4:
        //## File "/src/csrc/k.cu", line 70
        /*0090*/                   LDL R7, [R1+0xc] ;
        /*00a0*/               @P2 BRA `(.L_x_4) ;
        /*00b0*/                   RET.REL.NODEC R20 `(_Z4loopv) ;
"""


def test_sites_groups_local_loads_and_stores_by_line():
    got = spills.sites(LISTING, "k.cu")
    assert set(got) == {"_Z6kernelv", "_Z6helperv"}
    k = got["_Z6kernelv"]
    assert (k["LDL_bytes"], k["STL_bytes"]) == (4 + 2 * 16, 8)
    assert k["sites"] == [
        dict(op="LDL", bytes=4, count=1, line="k.cu:40", site="k.cu:40"),
        dict(op="STL", bytes=8, count=1, line="k.cu:40", site="k.cu:40"),
        dict(op="LDL", bytes=16, count=2, line="common.cuh:7", site="k.cu:90"),
    ]
    assert k["loops"] == []
    h = got["_Z6helperv"]
    assert (h["LDL_bytes"], h["STL_bytes"]) == (0, 4)


def test_sites_finds_the_loops_that_hold_local_accesses():
    f = spills.sites(LOOPS, "k.cu")["_Z4loopv"]
    assert (f["LDL_bytes"], f["STL_bytes"]) == (4 + 8 + 4 + 4, 4)
    assert [(lp["head"], lp["insns"], lp["lines"], lp["LDL_bytes"], lp["STL_bytes"])
            for lp in f["loops"]] == [("0x10", 3, [50, 51], 8, 0), ("0x90", 2, [70, 70], 4, 0)]
    assert f["loops"][0]["sites"] == [
        dict(op="LDL", bytes=8, count=1, line="k.cu:50", site="k.cu:50")]

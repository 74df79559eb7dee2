"""experiments/ptx_ops.py's PTX reading, on a PTX text written here (no
nvcc): the entries of a kernel by template arguments, their floating-point
opcodes counted, loads, stores and moves left out."""

from mba_vo_tpu_torch.experiments import ptx_ops

PTX = """
.visible .entry _ZN12_GLOBAL__N_126frame_layout_serial_kernelIdEEvPKT_S3_(
    .param .u64 a
)
{
    .reg .f64 %fd<9>;
    ld.global.f64 %fd7, [%rd1];
    add.rn.f64 %fd1, %fd2, %fd3;
    @%p1 bra $L1;
    @!%p2 mul.rn.f64 %fd1, %fd2, %fd3;
    {
    fma.rn.f64 %fd1, %fd2, %fd3, %fd4;
    }
    cvt.rmi.f64.f64 %fd5, %fd6;
    add.rn.f64 %fd1, %fd1, %fd3;
    mov.f64 %fd8, %fd1;
    st.global.f64 [%rd2], %fd8;
}
.visible .entry _ZN12_GLOBAL__N_126frame_layout_serial_kernelIfEEvPKT_S3_(
    .param .u64 a
)
{
    div.rn.f32 %f1, %f2, %f3;
    setp.lt.f32 %p1, %f1, 0f00000000;
}
.visible .entry _ZN12_GLOBAL__N_119frame_layout_kernelIfEEvPKT_S3_(
    .param .u64 a
)
{
    sqrt.rn.f32 %f1, %f2;
}
"""


def test_entries_count_each_kernels_floating_point_opcodes():
    got = ptx_ops.entries(PTX, "frame_layout_serial_kernel")
    assert got == {
        "frame_layout_serial_kernelIdE": {"add.rn.f64": 2, "mul.rn.f64": 1, "fma.rn.f64": 1,
                                          "cvt.rmi.f64.f64": 1},
        "frame_layout_serial_kernelIfE": {"div.rn.f32": 1, "setp.lt.f32": 1}}
    assert ptx_ops.entries(PTX, "frame_layout_kernel") == {
        "frame_layout_kernelIfE": {"sqrt.rn.f32": 1}}
    assert ptx_ops.entries(PTX, "image_bilinear_kernel") == {}

"""The fused backbone launches (kernels 2-4: the stem with block 0, the
stride-2 and stride-1 blocks): the least time the card could take for them
over their device time, by kernel name, per traced request."""

from bench_port.harness.readers import roofline

FUSED = ("fused_stem_kernel", "fused_block_f32_kernel", "fused_block_bf16_kernel")


def read(run):
    return roofline(run, FUSED)

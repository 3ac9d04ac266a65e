"""The name table of the port's row-conv kernels K1-K3 on the composite
forward (`boa_tpu_torch/models/unet.py:_rowconv_forward`): for each kernel,
the launch counter it adds to (`boa_tpu_torch/ops/rowconv.py:LAUNCHES`),
the substrings of its CUDA function names in a profiler trace, and the
layers of the PlainConvUNet (`nets/plainconvunet.py:layers` names; `last` is the
last decoder stage) that its launches compute, one launch a layer.

K1 runs `csrc/conv_in_act.cu` (`conv_in_act_kernel`, the 1-channel input
conv on `conv1_kernel`, a split call's `finish_kernel`), K2
`csrc/stride2conv.cu`, K3 `csrc/transpconv.cu`.
"""

KERNELS = {
    "k1": {"launches": "conv3d_rows",
           "device_names": ("conv_in_act_kernel", "conv1_kernel", "finish_kernel"),
           "layers": ("enc0.0", "enc0.1", "last.0", "last.1")},
    "k2": {"launches": "conv3d_rows_stride2",
           "device_names": ("stride2_kernel",),
           "layers": ("enc1.0",)},
    "k3": {"launches": "transpconv2_rows",
           "device_names": ("transp_kernel",),
           "layers": ("last.up",)},
}


def layer_names(kernel: str, n_stages: int) -> tuple[str, ...]:
    last = f"dec{n_stages - 2}"
    return tuple(n.replace("last", last) for n in KERNELS[kernel]["layers"])

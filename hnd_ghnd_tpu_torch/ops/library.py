"""The port's kernels as ``torch.library`` custom ops, namespace ``hnd_ghnd``.

A custom op is what ``torch.export`` records as one node and a loaded
artifact calls back into (split/export.py).  Importing this module
registers every op.  Each kernel module defines its own ops on the
namespace of ops/_oplib.py, by schema on a ``torch.library.Library`` with
a kernel per dispatch key (a call costs ~5 us of dispatch on the host
here, against ~20 us through ``torch.library.custom_op``'s wrapper):

  * ``quantize``, ``dequantize`` (ops/quant_kernels.py);
  * ``roi_align`` on float32, bfloat16 and int8 tables, ``quantize_levels``
    (ops/roi_align_kernels.py);
  * ``stem_fwd`` (ops/stem_kernels.py);
  * ``nms_keep``, ``nms_keep_levels`` (ops/nms.py).

Each op has:

  * a fake implementation (``register_fake``): shapes and dtypes only, for
    tracing; it reads no data and no pointer;
  * a CPU implementation: the plain PyTorch version the kernel is held
    against (codec/quantizer.py, ops/roi_align.py, ops/stem.py, the NMS
    fixpoint of ops/nms.py);
  * a CUDA implementation: the kernel's launch (the module's ``launch_*``),
    which checks what the kernel takes, raises on anything else, allocates
    the outputs and work buffers, picks vector widths from the pointers,
    and counts the launch on its wrapper's ``launches``; so a launch inside
    a loaded artifact is counted like any other.

The public wrappers (``quant_kernels.quantize`` / ``dequantize``,
``roi_align_kernels.roi_align`` / ``quantize_levels``,
``stem_kernels.stem_fwd``, ``nms.nms_keep``, ``nms.nms_keep_levels``)
raise ValueError for a tensor neither on the CPU nor on CUDA
(``_oplib.check_device``; on meta tensors the ops themselves give shapes,
as under tracing) and call the ops.  An
op's outputs alias neither its inputs nor each other: ``quantize`` returns
the scale and zero point as one [2] tensor, and ``quantize_levels`` one
tensor per level's codes.  The training paths (``RoIAlignFunction``,
``StemConvBnRelu``) launch their kernels directly.  Nothing is built or
launched when the ops are defined.
"""
from hnd_ghnd_tpu_torch.ops import nms as _nms  # noqa: F401
from hnd_ghnd_tpu_torch.ops import quant_kernels as _quant  # noqa: F401
from hnd_ghnd_tpu_torch.ops import roi_align_kernels as _roi  # noqa: F401
from hnd_ghnd_tpu_torch.ops import stem_kernels as _stem  # noqa: F401
from hnd_ghnd_tpu_torch.ops._oplib import NAMESPACE  # noqa: F401

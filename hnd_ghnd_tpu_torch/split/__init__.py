from hnd_ghnd_tpu_torch.split.deploy import (JpegInputSplit, SplitRCNN,
                                             WireError, WirePacket, pack_wire,
                                             split_rcnn_model, unpack_wire)

__all__ = ["JpegInputSplit", "SplitRCNN", "WireError", "WirePacket",
           "pack_wire", "split_rcnn_model", "unpack_wire"]

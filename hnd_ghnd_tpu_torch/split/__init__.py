from hnd_ghnd_tpu_torch.split.deploy import (JpegInputSplit, SplitRCNN,
                                             WireError, WirePacket, pack_wire,
                                             split_rcnn_model, unpack_wire)
from hnd_ghnd_tpu_torch.split.export import export_split, load_exported
from hnd_ghnd_tpu_torch.split.int8 import (Int8SplitTail, calibrate_from_images,
                                           calibrate_tail, fold_tail,
                                           quantize_folded, trunk_features_fp,
                                           trunk_features_int8)

__all__ = ["Int8SplitTail", "JpegInputSplit", "SplitRCNN", "WireError",
           "WirePacket", "calibrate_from_images", "calibrate_tail",
           "export_split", "fold_tail", "load_exported", "pack_wire",
           "quantize_folded", "split_rcnn_model", "trunk_features_fp",
           "trunk_features_int8", "unpack_wire"]

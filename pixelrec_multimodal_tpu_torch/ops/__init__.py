# pixelrec_multimodal_tpu_torch/ops/__init__.py

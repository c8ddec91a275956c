# pixelrec_multimodal_tpu_torch/models/__init__.py

# pixelrec_multimodal_tpu_torch/utils/__init__.py

# pixelrec_multimodal_tpu_torch/data/__init__.py

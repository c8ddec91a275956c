# pixelrec_multimodal_tpu_torch/inference/__init__.py

"""The port's command-line entry points, run as modules:

    python -m pixelrec_multimodal_tpu_torch.scripts.create_splits --config X.yaml
    python -m pixelrec_multimodal_tpu_torch.scripts.train --config X.yaml
    python -m pixelrec_multimodal_tpu_torch.scripts.generate_recommendations --config X.yaml
    python -m pixelrec_multimodal_tpu_torch.scripts.evaluate --config X.yaml --test_data T.csv
    python -m pixelrec_multimodal_tpu_torch.scripts.create_training_subsets --config X.yaml
    python -m pixelrec_multimodal_tpu_torch.scripts.hyperparameter_search --config X.yaml
    python -m pixelrec_multimodal_tpu_torch.scripts.checkpoint_manager list
    python -m pixelrec_multimodal_tpu_torch.scripts.inspect_checkpoint DIR
    python -m pixelrec_multimodal_tpu_torch.scripts.extract_encoders --config X.yaml

Each takes the JAX package's script's flags (``scripts/*.py`` at the root
of the repo) and writes the same files; the train, generate, evaluate and
search entry points run on the CUDA device unless ``--device cpu`` is
given."""

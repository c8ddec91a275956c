# pixelrec_multimodal_tpu_torch/encoders/convert.py
"""HF torch checkpoints -> the port's encoder towers.

A copy of ``pixelrec_multimodal_tpu/encoders/convert.py``'s converters,
which take an HF ``state_dict`` (tensors or numpy arrays) and return the
Flax parameter tree of the JAX package's towers (torch Linear [out, in]
-> [in, out], Conv [out, in, kh, kw] -> [kh, kw, in, out]); the port's
towers carry the same names, so ``utils/flax_convert.encoder_state_dict``
turns that tree into their state dicts. Going through the Flax tree keeps
one mapping of HF names, held against JAX's by the tests.

``load_pretrained_params`` loads a locally cached HF checkpoint; it
returns None where the checkpoint or ``transformers`` is missing, without
importing ``transformers`` where the checkpoint is not on the disk, and
never tries a download. A checkpoint on the disk that fails to load
raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import MODEL_CONFIGS
from ..data.tokenization import hf_files_present
from ..utils.flax_convert import encoder_state_dict


def _np(t) -> np.ndarray:
    if hasattr(t, 'detach'):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _dense(sd, prefix):
    return {'kernel': _np(sd[f'{prefix}.weight']).T,
            'bias': _np(sd[f'{prefix}.bias'])}


def _ln(sd, prefix):
    return {'scale': _np(sd[f'{prefix}.weight']),
            'bias': _np(sd[f'{prefix}.bias'])}


def _conv(sd, prefix, bias=True):
    # [out, in, kh, kw] -> [kh, kw, in, out]; depthwise [out, 1, kh, kw] ->
    # [kh, kw, 1, out]
    out = {'kernel': _np(sd[f'{prefix}.weight']).transpose(2, 3, 1, 0)}
    if bias and f'{prefix}.bias' in sd:
        out['bias'] = _np(sd[f'{prefix}.bias'])
    return out


def _bn(sd, prefix):
    return {'scale': _np(sd[f'{prefix}.weight']),
            'bias': _np(sd[f'{prefix}.bias']),
            'mean': _np(sd[f'{prefix}.running_mean']),
            'var': _np(sd[f'{prefix}.running_var'])}


def _attention(sd, q, k, v, o):
    return {'query': _dense(sd, q), 'key': _dense(sd, k),
            'value': _dense(sd, v), 'out': _dense(sd, o)}


# ---------------------------------------------------------------- text family
def convert_bert_family(sd: Dict[str, Any], num_layers: int,
                        has_token_type: bool = True,
                        has_relative_bias: bool = False) -> Dict[str, Any]:
    """BertModel / RobertaModel / MPNetModel state_dict -> TextTransformer."""
    mpnet = 'encoder.layer.0.attention.attn.q.weight' in sd
    params: Dict[str, Any] = {
        'word_embeddings': {'embedding': _np(sd['embeddings.word_embeddings.weight'])},
        'position_embeddings': {'embedding': _np(sd['embeddings.position_embeddings.weight'])},
        'embeddings_norm': _ln(sd, 'embeddings.LayerNorm'),
        'pooler': _dense(sd, 'pooler.dense'),
    }
    if has_token_type and 'embeddings.token_type_embeddings.weight' in sd:
        params['token_type_embeddings'] = {
            'embedding': _np(sd['embeddings.token_type_embeddings.weight'])}
    if has_relative_bias and 'encoder.relative_attention_bias.weight' in sd:
        params['relative_attention_bias'] = {
            'embedding': _np(sd['encoder.relative_attention_bias.weight'])}
    for i in range(num_layers):
        p = f'encoder.layer.{i}'
        if mpnet:
            attn = _attention(sd, f'{p}.attention.attn.q',
                              f'{p}.attention.attn.k',
                              f'{p}.attention.attn.v',
                              f'{p}.attention.attn.o')
            attn_norm = _ln(sd, f'{p}.attention.LayerNorm')
        else:
            attn = _attention(sd, f'{p}.attention.self.query',
                              f'{p}.attention.self.key',
                              f'{p}.attention.self.value',
                              f'{p}.attention.output.dense')
            attn_norm = _ln(sd, f'{p}.attention.output.LayerNorm')
        params[f'layer_{i}'] = {
            'attention': attn,
            'attention_norm': attn_norm,
            'intermediate': _dense(sd, f'{p}.intermediate.dense'),
            'output': _dense(sd, f'{p}.output.dense'),
            'output_norm': _ln(sd, f'{p}.output.LayerNorm'),
        }
    return params


# ----------------------------------------------------------------------- CLIP
def _clip_layers(sd, prefix, num_layers):
    out = {}
    for i in range(num_layers):
        p = f'{prefix}.encoder.layers.{i}'
        out[f'layer_{i}'] = {
            'attention': _attention(sd, f'{p}.self_attn.q_proj',
                                    f'{p}.self_attn.k_proj',
                                    f'{p}.self_attn.v_proj',
                                    f'{p}.self_attn.out_proj'),
            'norm1': _ln(sd, f'{p}.layer_norm1'),
            'norm2': _ln(sd, f'{p}.layer_norm2'),
            'fc1': _dense(sd, f'{p}.mlp.fc1'),
            'fc2': _dense(sd, f'{p}.mlp.fc2'),
        }
    return out


def convert_clip_vision(sd: Dict[str, Any], num_layers: int = 12
                        ) -> Dict[str, Any]:
    """CLIPVisionModel state_dict -> CLIPVisionTower params."""
    params = {
        'class_embedding': _np(sd['vision_model.embeddings.class_embedding']),
        'position_embedding': _np(
            sd['vision_model.embeddings.position_embedding.weight']),
        'patch_embedding': _conv(sd, 'vision_model.embeddings.patch_embedding',
                                 bias=False),
        'pre_layrnorm': _ln(sd, 'vision_model.pre_layrnorm'),
        'post_layernorm': _ln(sd, 'vision_model.post_layernorm'),
    }
    params.update(_clip_layers(sd, 'vision_model', num_layers))
    return params


def convert_clip_text(sd: Dict[str, Any], num_layers: int = 12
                      ) -> Dict[str, Any]:
    """CLIPTextModel state_dict -> CLIPTextTower params."""
    params = {
        'token_embedding': {'embedding': _np(
            sd['text_model.embeddings.token_embedding.weight'])},
        'position_embedding': _np(
            sd['text_model.embeddings.position_embedding.weight']),
        'final_layer_norm': _ln(sd, 'text_model.final_layer_norm'),
    }
    params.update(_clip_layers(sd, 'text_model', num_layers))
    return params


# --------------------------------------------------------------------- DINOv2
def convert_dinov2(sd: Dict[str, Any], num_layers: int = 12) -> Dict[str, Any]:
    """Dinov2Model state_dict -> Dinov2Tower params."""
    params = {
        'cls_token': _np(sd['embeddings.cls_token']).reshape(1, 1, -1),
        'position_embeddings': _np(sd['embeddings.position_embeddings']),
        'patch_embedding': _conv(sd, 'embeddings.patch_embeddings.projection'),
        'layernorm': _ln(sd, 'layernorm'),
    }
    for i in range(num_layers):
        p = f'encoder.layer.{i}'
        params[f'layer_{i}'] = {
            'norm1': _ln(sd, f'{p}.norm1'),
            'attention': _attention(sd, f'{p}.attention.attention.query',
                                    f'{p}.attention.attention.key',
                                    f'{p}.attention.attention.value',
                                    f'{p}.attention.output.dense'),
            'layerscale1': _np(sd[f'{p}.layer_scale1.lambda1']),
            'norm2': _ln(sd, f'{p}.norm2'),
            'fc1': _dense(sd, f'{p}.mlp.fc1'),
            'fc2': _dense(sd, f'{p}.mlp.fc2'),
            'layerscale2': _np(sd[f'{p}.layer_scale2.lambda1']),
        }
    return params


# --------------------------------------------------------------------- ResNet
def convert_resnet(sd: Dict[str, Any],
                   depths=(3, 4, 6, 3)) -> Dict[str, Any]:
    """ResNetModel state_dict -> ResNetTower params."""

    def convbn(prefix):
        return {'conv': _conv(sd, f'{prefix}.convolution', bias=False),
                'bn': _bn(sd, f'{prefix}.normalization')}

    params: Dict[str, Any] = {'stem': convbn('embedder.embedder')}
    for s, depth in enumerate(depths):
        for b in range(depth):
            p = f'encoder.stages.{s}.layers.{b}'
            block = {
                'conv1': convbn(f'{p}.layer.0'),
                'conv2': convbn(f'{p}.layer.1'),
                'conv3': convbn(f'{p}.layer.2'),
            }
            if f'{p}.shortcut.convolution.weight' in sd:
                block['shortcut'] = convbn(f'{p}.shortcut')
            params[f'stage_{s}_block_{b}'] = block
    return params


# ------------------------------------------------------------------- ConvNeXt
def convert_convnext(sd: Dict[str, Any],
                     depths=(3, 3, 27, 3)) -> Dict[str, Any]:
    """ConvNextModel state_dict -> ConvNextTower params."""
    params: Dict[str, Any] = {
        'stem_conv': _conv(sd, 'embeddings.patch_embeddings'),
        'stem_norm': _ln(sd, 'embeddings.layernorm'),
        'final_layernorm': _ln(sd, 'layernorm'),
    }
    for s, depth in enumerate(depths):
        if s > 0:
            params[f'downsample_norm_{s}'] = _ln(
                sd, f'encoder.stages.{s}.downsampling_layer.0')
            params[f'downsample_conv_{s}'] = _conv(
                sd, f'encoder.stages.{s}.downsampling_layer.1')
        for b in range(depth):
            p = f'encoder.stages.{s}.layers.{b}'
            params[f'stage_{s}_block_{b}'] = {
                'dwconv': _conv(sd, f'{p}.dwconv'),
                'norm': _ln(sd, f'{p}.layernorm'),
                'pwconv1': _dense(sd, f'{p}.pwconv1'),
                'pwconv2': _dense(sd, f'{p}.pwconv2'),
                'layer_scale': _np(sd[f'{p}.layer_scale_parameter']),
            }
    return params


# ------------------------------------------------------------------- loading
_HF_CLASSES = {
    ('vision', 'clip'): ('CLIPVisionModel', convert_clip_vision),
    ('vision', 'dino'): ('Dinov2Model', convert_dinov2),
    ('vision', 'resnet'): ('ResNetModel', convert_resnet),
    ('vision', 'convnext'): ('ConvNextModel', convert_convnext),
    ('language', 'bert'): ('AutoModel', convert_bert_family),
    ('language', 'sentence-bert'): ('AutoModel', convert_bert_family),
    ('language', 'roberta'): ('AutoModel', convert_bert_family),
    ('language', 'mpnet'): ('AutoModel', convert_bert_family),
    ('clip_text', 'clip'): ('CLIPTextModel', convert_clip_text),
}

_TEXT_LAYERS = {'bert': 12, 'sentence-bert': 6, 'roberta': 12, 'mpnet': 12}


def load_pretrained_params(modality: str, model_key: str
                           ) -> Optional[Dict[str, torch.Tensor]]:
    """A locally cached HF checkpoint as the port tower's state dict; None
    when ``transformers`` or the checkpoint is unavailable. A checkpoint
    that is on the disk but fails to load raises (JAX's loader returns
    None, and the precompute would go on with random weights)."""
    entry = _HF_CLASSES.get((modality, model_key))
    if entry is None:
        return None
    class_name, converter = entry
    hf_name = MODEL_CONFIGS['vision' if modality == 'clip_text'
                            else modality][model_key]['name']
    if not hf_files_present(hf_name):
        return None
    try:
        import transformers
    except ImportError:
        return None
    # adapter_kwargs: where PEFT is installed, transformers looks for an
    # adapter config with its own kwargs, which local_files_only does not
    # reach, and would go to the network.
    model = getattr(transformers, class_name).from_pretrained(
        hf_name, local_files_only=True,
        adapter_kwargs={'local_files_only': True})
    sd = model.state_dict()
    if modality == 'language':
        params = converter(sd, _TEXT_LAYERS[model_key],
                           has_relative_bias=(model_key == 'mpnet'))
    else:
        params = converter(sd)
    return encoder_state_dict(params)

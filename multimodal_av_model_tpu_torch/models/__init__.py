from .audio import AudioEncoder
from .av_model import (
    AudioOnlyCTC,
    MultiSpeakerAVModel,
    VisualOnlyCTC,
    downsample_mask_to,
    nchw_clip_to_channels_last,
)
from .decoder import CTCDecoder
from .fusion import CrossAttentionFusion
from .layers import init_weights
from .visual import VisualEncoder

__all__ = [
    "AudioEncoder",
    "AudioOnlyCTC",
    "CTCDecoder",
    "CrossAttentionFusion",
    "MultiSpeakerAVModel",
    "VisualEncoder",
    "VisualOnlyCTC",
    "downsample_mask_to",
    "init_weights",
    "nchw_clip_to_channels_last",
]

from .audio import AudioEncoder
from .av_model import (
    AudioOnlyCTC,
    MultiSpeakerAVModel,
    VisualOnlyCTC,
    build_av_model,
    downsample_mask_to,
    nchw_clip_to_channels_last,
)
from .avhubert import AVHubertCTC
from .decoder import CTCDecoder
from .fusion import CrossAttentionFusion
from .layers import BiGRU, GRULayer, init_weights
from .legacy import LipEncoder, MelAudioEncoder, MultimodalCTCKoreanModel, init_legacy_weights
from .visual import VisualEncoder

__all__ = [
    "AVHubertCTC",
    "AudioEncoder",
    "BiGRU",
    "GRULayer",
    "LipEncoder",
    "MelAudioEncoder",
    "MultimodalCTCKoreanModel",
    "AudioOnlyCTC",
    "CTCDecoder",
    "CrossAttentionFusion",
    "MultiSpeakerAVModel",
    "VisualEncoder",
    "VisualOnlyCTC",
    "build_av_model",
    "downsample_mask_to",
    "init_legacy_weights",
    "init_weights",
    "nchw_clip_to_channels_last",
]

"""Batched feature extraction on torch tensors (counterpart of ``tpuvae.dsp``).

The JAX package's ``jit_extractor`` is :func:`features.make_extractor`
here; ``stft_power_framesharded`` / ``mel_image_framesharded`` shard a
long clip's frame axis over a mesh (``dsp/long.py``)."""

from tpuvae_torch.dsp.primitives import (  # noqa: F401
    hann_window,
    num_frames,
    frame_signal,
    stft_power,
    fft_frequencies,
    mel_filterbank,
    power_to_db,
    dct_ii_ortho,
)
from tpuvae_torch.dsp.features import (  # noqa: F401
    resolve_numerics,
    resolve_transfer_dtype,
    mel_power_from_stft,
    mel_db_ref_max,
    mfcc_from_mel_power,
    spectral_centroid,
    spectral_bandwidth,
    spectral_rolloff,
    zero_crossing_rate,
    rms,
    extract_basic_features,
    extract_mel_image,
    extract_flat_features,
    extract_advanced,
    make_extractor,
)
from tpuvae_torch.dsp.chroma import (  # noqa: F401
    chroma_filterbank,
    chroma_from_power,
    chroma_batch,
    estimate_tuning_from_power,
    piptrack_from_power,
)
from tpuvae_torch.dsp.long import (  # noqa: F401
    stft_power_framesharded,
    mel_image_framesharded,
)

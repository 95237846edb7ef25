"""Host I/O: audio decoding (native C++ loader, WAV, FLAC, MP3), the
synthetic corpus, the preprocessing normalizers and artifacts."""

from tpuvae_torch.io.wav import load_audio, read_wav, to_mono, resample_poly  # noqa: F401
from tpuvae_torch.io.mp3 import mp3_available, read_mp3  # noqa: F401
from tpuvae_torch.io.catalog import AudioEntry, collect_audio_files, load_metadata  # noqa: F401
from tpuvae_torch.io.normalize import (  # noqa: F401
    MeanImputer,
    StandardScaler,
    impute_and_scale,
    normalize_mel_images,
)
from tpuvae_torch.io.artifacts import (  # noqa: F401
    save_basic,
    save_advanced,
    load_basic,
    load_advanced,
)
from tpuvae_torch.io.results import consolidate_metrics  # noqa: F401
from tpuvae_torch.io.synthetic import (  # noqa: F401
    generate_dataset,
    generate_memory_batch,
    synth_clip,
    write_wav,
)

"""Lyrics embedding (counterpart of ``tpuvae/text``): hashed n-grams, and
the XLM-RoBERTa sentence encoder run from a checkpoint directory."""

from tpuvae_torch.text.hashing import embed_text, embed_texts  # noqa: F401
from tpuvae_torch.text.encoder import (  # noqa: F401
    EncoderConfig,
    SentenceEncoder,
    convert_hf_state_dict,
    infer_encoder_config,
)
from tpuvae_torch.text.embedder import (  # noqa: F401
    create_lyrics_embeddings,
    embed_lyrics,
)

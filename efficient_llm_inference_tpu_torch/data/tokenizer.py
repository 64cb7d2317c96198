"""Byte-level tokenizer (copy of efficient_llm_inference_tpu/data/tokenizer.py
without the optional HuggingFace loader: the port depends on no tokenizer
package)."""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """UTF-8 byte tokenizer: token id == byte value (vocab 256 + specials)."""

    def __init__(self, eos_token_id: Optional[int] = None):
        self.eos_token_id = eos_token_id
        self.vocab_size = 256 if eos_token_id is None else max(257, eos_token_id + 1)

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        byts = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return byts.decode("utf-8", errors="replace")

    def __call__(self, text: str, **kw):
        # Minimal HF-call compatibility: returns an object with .input_ids.
        class _Enc:
            def __init__(self, ids):
                self.input_ids = [ids]

        return _Enc(self.encode(text))


def load_tokenizer(model_name: str = "gpt2") -> ByteTokenizer:
    """The tokenizer for `model_name`: the byte tokenizer for every model."""
    return ByteTokenizer()

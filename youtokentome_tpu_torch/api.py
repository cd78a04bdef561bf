"""Public Python API, drop-in compatible with ``youtokentome``.

PyTorch counterpart of ``youtokentome_tpu/api.py``: class ``BPE`` with
encode/decode/vocab/vocab_size/subword_to_id/id_to_subword and the
``OutputType`` enum, plus pickling by model path
(youtokentome.py:90-99).

``device`` selects where training runs and where novel words are merged:
``cuda`` by default (the hand-written kernels), or ``cpu`` (their plain
torch versions).
"""

from __future__ import annotations

from enum import Enum
from typing import Collection, List, Optional, Union

from .encoder import Encoder
from .models.state import BPEState, BpeConfig, SpecialTokens


class OutputType(Enum):
    ID = 1
    SUBWORD = 2


class BPE:
    def __init__(self, model: str, n_threads: int = -1, device=None):
        self.model = model
        self.n_threads = n_threads
        self._state = BPEState.load(model)
        self._encoder = Encoder(self._state, device=device)

    @staticmethod
    def train(
        data: str,
        model: str,
        vocab_size: int,
        coverage: float = 1.0,
        n_threads: int = -1,
        pad_id: int = 0,
        unk_id: int = 1,
        bos_id: int = 2,
        eos_id: int = 3,
        device=None,
    ) -> "BPE":
        from .train import train as train_impl

        config = BpeConfig(
            character_coverage=coverage,
            n_threads=n_threads,
            special_tokens=SpecialTokens(
                pad_id=pad_id, unk_id=unk_id, bos_id=bos_id, eos_id=eos_id
            ),
        )
        train_impl(data, model, vocab_size, config, device=device)
        return BPE(model=model, n_threads=n_threads, device=device)

    @property
    def device(self):
        return self._encoder.device

    def encode(
        self,
        sentences: Union[str, List[str]],
        output_type: "OutputType" = OutputType.ID,
        bos: bool = False,
        eos: bool = False,
        reverse: bool = False,
        dropout_prob: float = 0,
        generator=None,
    ):
        """As ``youtokentome.BPE.encode``; ``generator`` (a
        ``torch.Generator``) seeds BPE-dropout, which otherwise draws its
        seed from ``os.urandom``."""
        if not isinstance(output_type, OutputType):
            raise TypeError(
                f"output_type must be an OutputType enum value, "
                f"got {type(output_type)}"
            )
        ot = "id" if output_type == OutputType.ID else "subword"
        # single-string convenience: flat result (yttm.pyx:95-100, 109-115)
        if isinstance(sentences, str):
            return self._encoder.encode(
                [sentences], ot, bos, eos, reverse, dropout_prob, generator
            )[0]
        if not isinstance(sentences, (list, tuple)):
            raise TypeError("sentences must be a str, list or tuple")
        return self._encoder.encode(
            list(sentences), ot, bos, eos, reverse, dropout_prob, generator
        )

    def vocab_size(self) -> int:
        return self._encoder.vocab.vocab_size()

    def vocab(self) -> List[str]:
        return self._encoder.vocab.vocabulary()

    def subword_to_id(self, subword: str) -> int:
        return self._encoder.vocab.subword_to_id(subword)

    def id_to_subword(self, id: int) -> str:
        return self._encoder.vocab.id_to_subword(id)

    def decode(
        self,
        ids: Union[List[int], List[List[int]]],
        ignore_ids: Optional[Collection[int]] = None,
    ) -> List[str]:
        if not isinstance(ids, list):
            raise TypeError("{} is not a list instance".format(type(ids)))
        if ignore_ids is not None and not isinstance(ignore_ids, Collection):
            raise TypeError(
                "{} is not a Collection instance".format(type(ignore_ids))
            )
        if len(ids) > 0 and isinstance(ids[0], int):
            ids = [ids]
        return [self._encoder.vocab.decode_ids(s, ignore_ids) for s in ids]

    def __getstate__(self):
        return {"model": self.model, "n_threads": self.n_threads, "device": str(self.device)}

    def __setstate__(self, d):
        self.model = d["model"]
        self.n_threads = d["n_threads"]
        self._state = BPEState.load(self.model)
        self._encoder = Encoder(self._state, device=d["device"])

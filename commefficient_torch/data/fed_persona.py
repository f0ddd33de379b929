"""Federated PersonaChat: one natural client per personality.

A copy of the JAX package's ``data/fed_persona.py`` on the port's
``FedDataset`` (data/fed_dataset.py), so the two packages pack the same
items into the same arrays and share one prepared directory. Items are
next-utterance classification instances: ``num_candidates`` candidate
replies (gold last), each encoded as persona + dialogue history + reply
with speaker segment tokens, padded to a static ``max_seq_len`` into int32
arrays ``input_ids``, ``token_type_ids``, ``lm_labels`` (items, C, S),
``mc_token_ids`` (items, C) and ``mc_label`` (items,), sorted by client.
``do_iid`` deals a fixed permutation (``RandomState(0)``) to
``num_clients``, as the base class does.

The corpus is ``personachat_self_original.json`` under ``dataset_dir``
when it is there, else the JAX package's synthetic dialogues. The
tokenizer is ``HashTokenizer`` (8,192 word buckets + 5 special tokens;
the GPT-2 BPE tokenizer is not ported). Both splits are packed once and
written under ``dataset_dir`` in the JAX package's layout:
``FedPERSONA_persona_train.npz``, ``FedPERSONA_persona_val.npz``,
``stats_FedPERSONA.json`` and the prep sidecar
``FedPERSONA_persona_prep.json`` (the packing knobs, the tokenizer and the
corpus source); a later run, of either package, reads them unless a knob
changed, which packs again. A layout of earlier JAX package versions
(unprefixed ``persona_*`` files) is adopted, or set aside as
``*.stale``, as the JAX package does.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from commefficient_torch.data.fed_dataset import FedDataset

SPECIAL_TOKENS = ["<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>"]
LM_IGNORE = -100


class HashTokenizer:
    """Deterministic word-level hash tokenizer: crc32 buckets (stable
    across processes); the special tokens take the top ids."""

    def __init__(self, base_vocab: int = 8192):
        self.base_vocab = base_vocab
        self.special = {t: base_vocab + i for i, t in
                        enumerate(SPECIAL_TOKENS)}

    def __len__(self):
        return self.base_vocab + len(SPECIAL_TOKENS)

    def encode(self, text: str) -> List[int]:
        return [zlib.crc32(w.lower().encode()) % self.base_vocab
                for w in text.split()]

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.special[tokens]
        return [self.special[t] for t in tokens]


def build_input_from_segments(persona: Sequence[List[int]],
                              history: Sequence[List[int]],
                              reply: List[int], tokenizer,
                              lm_labels: bool = False) -> Dict:
    """One candidate sequence: ``<bos> persona <speaker2/1 alternating>
    history ... <speaker2> reply <eos>``; token types mark each segment
    with its speaker token; LM labels cover only the gold reply (and
    ``<eos>``)."""
    bos, eos, spk1, spk2 = [
        tokenizer.convert_tokens_to_ids(t) for t in SPECIAL_TOKENS[:4]]
    seqs = [[bos] + [t for s in persona for t in s]]
    for i, h in enumerate(history):
        spk = spk2 if (len(history) - i) % 2 == 1 else spk1
        seqs.append([spk] + h)
    seqs.append([spk2] + reply + [eos])

    words, types = [], []
    for seq in seqs:
        spk = spk2 if seq and seq[0] == spk2 else spk1
        words.extend(seq)
        types.extend([spk] * len(seq))
    labels = [LM_IGNORE] * (len(words) - len(seqs[-1]) + 1) + seqs[-1][1:]
    return {"input_ids": words, "token_type_ids": types,
            "lm_labels": labels if lm_labels else [LM_IGNORE] * len(words)}


def synthetic_personachat(num_personalities: int = 12,
                          dialogs_per: int = 3, seed: int = 5):
    """The JAX package's synthetic dialogues (``_synthetic_personachat``):
    random sentences over a 15-word vocabulary, two candidates each."""
    rng = np.random.RandomState(seed)
    words = ["i", "like", "cats", "dogs", "music", "pizza", "running",
             "books", "you", "do", "what", "love", "my", "hobby", "is"]

    def sent():
        return " ".join(rng.choice(words, size=rng.randint(3, 7)))

    data = []
    for _ in range(num_personalities):
        personality = [sent() for _ in range(4)]
        utterances = []
        history = []
        for _ in range(dialogs_per):
            history = history + [sent()]
            utterances.append({
                "history": list(history),
                "candidates": [sent(), sent()],  # gold last
            })
        data.append({"personality": personality, "utterances": utterances})
    return data


class FedPERSONA(FedDataset):
    """``train=True``: the training split, one client per personality
    (``num_clients`` a multiple of that count splits each, or any count
    under ``do_iid``); ``train=False``: the validation split.
    ``personality_permutations`` rotates the persona sentences to augment
    the training split only; both splits' packs are written at once, so
    pass the same knobs to both."""

    def __init__(self, dataset_dir: str = "./dataset", train: bool = True,
                 do_iid: bool = False, num_clients: Optional[int] = None,
                 tokenizer=None, num_candidates: int = 2,
                 max_seq_len: int = 128, max_history: int = 2,
                 personality_permutations: int = 1,
                 synthetic: Optional[bool] = None):
        self.dataset_dir = dataset_dir
        self.tokenizer = tokenizer or HashTokenizer()
        self.num_candidates = num_candidates
        self.max_seq_len = max_seq_len
        self.max_history = max_history
        self.personality_permutations = personality_permutations
        self._synthetic = synthetic
        corpus_json = os.path.join(dataset_dir,
                                   "personachat_self_original.json")
        # what the packs bake in: a change to any of it packs again
        self._prep_config = {
            "num_candidates": num_candidates,
            "max_seq_len": max_seq_len,
            "max_history": max_history,
            "personality_permutations": personality_permutations,
            "tokenizer": [type(self.tokenizer).__name__,
                          len(self.tokenizer)],
            "corpus": ("real" if (os.path.exists(corpus_json)
                                  and not synthetic) else "synthetic"),
        }
        self._check_prep(dataset_dir)
        super().__init__(dataset_dir, train=train, do_iid=do_iid,
                         num_clients=num_clients)

    def _check_prep(self, dataset_dir: str) -> None:
        """The JAX package's staleness rules, before the base class looks
        for the stats. The sidecar is read under the prefixed name, else
        an earlier version's plain ``persona_prep.json``; a pack without
        any sidecar was packed under other rules and is stale. A plain
        layout (pack and sidecar unprefixed beside the prefixed stats)
        that matches is renamed into the prefixed names, not packed
        again. A stale cache loses its prefixed stats (and a plain
        ``stats.json`` whose item count is the plain pack's), and its
        plain files are renamed to ``*.stale``, never deleted."""
        cfg_pref = self.data_fn("persona_prep.json")
        cfg_legacy = os.path.join(dataset_dir, "persona_prep.json")
        npz_pref = self.data_fn("persona_train.npz")
        npz_legacy = os.path.join(dataset_dir, "persona_train.npz")
        val_legacy = os.path.join(dataset_dir, "persona_val.npz")
        saved_cfg = cfg_src = None
        for fn in (cfg_pref, cfg_legacy):
            if os.path.exists(fn):
                with open(fn) as f:
                    saved_cfg = json.load(f)
                cfg_src = fn
                break
        have_pack = os.path.exists(npz_pref) or os.path.exists(npz_legacy)
        stale = (saved_cfg != self._prep_config if saved_cfg is not None
                 else have_pack)
        if (not stale and cfg_src == cfg_legacy
                and os.path.exists(npz_legacy)
                and not os.path.exists(npz_pref)
                and os.path.exists(self._prefixed_stats_fn())):
            os.rename(npz_legacy, npz_pref)
            if os.path.exists(val_legacy):
                os.rename(val_legacy, self.data_fn("persona_val.npz"))
            os.rename(cfg_legacy, cfg_pref)
        if not stale:
            return
        pref = self._prefixed_stats_fn()
        if os.path.exists(pref):
            os.unlink(pref)
        plain = os.path.join(dataset_dir, "stats.json")
        if os.path.exists(plain) and os.path.exists(npz_legacy):
            try:
                with open(plain) as pf:
                    n_stats = sum(json.load(pf)["images_per_client"])
                with np.load(npz_legacy) as z:
                    n_items = len(z["mc_label"])
            except (OSError, ValueError, KeyError, TypeError, EOFError,
                    zipfile.BadZipFile):
                n_stats, n_items = -1, -2
            if n_stats == n_items:
                os.unlink(plain)
        for fn in (npz_legacy, val_legacy, cfg_legacy):
            if os.path.exists(fn):
                os.replace(fn, fn + ".stale")

    def _prepare(self) -> None:
        """Pack both splits and write them, the sidecar and the stats."""
        train_raw, val_raw = self._raw_corpus()
        train, per_client = self._pack_split(
            train_raw, permutations=self.personality_permutations)
        val, _ = self._pack_split(val_raw)
        os.makedirs(self.dataset_dir, exist_ok=True)
        np.savez(self.data_fn("persona_train.npz"), **train)
        np.savez(self.data_fn("persona_val.npz"), **val)
        with open(self.data_fn("persona_prep.json"), "w") as f:
            json.dump(self._prep_config, f)
        self.write_stats(per_client, len(val["mc_label"]))

    def _load_arrays(self) -> None:
        fn = "persona_train.npz" if self.train else "persona_val.npz"
        with np.load(self.data_fn(fn)) as d:
            self.arrays = {k: d[k] for k in d.files}

    def _raw_corpus(self):
        fn = os.path.join(self.dataset_dir, "personachat_self_original.json")
        if os.path.exists(fn) and not self._synthetic:
            with open(fn) as f:
                blob = json.load(f)
            return blob["train"], blob["valid"]
        if self._synthetic is False:
            raise FileNotFoundError(f"no personachat json under "
                                    f"{self.dataset_dir}")
        if self._synthetic is None:
            print(f"WARNING: no personachat json under {self.dataset_dir}; "
                  "generating synthetic dialogues")
        return (synthetic_personachat(12, 3, seed=5),
                synthetic_personachat(4, 2, seed=6))

    def _pack_split(self, dialogs, permutations: int = 1):
        tok = self.tokenizer
        C, S = self.num_candidates, self.max_seq_len
        # group dialogs by personality => natural clients
        groups: Dict[str, list] = {}
        for d in dialogs:
            groups.setdefault("\n".join(d["personality"]), []).append(d)

        rows = {"input_ids": [], "token_type_ids": [], "lm_labels": [],
                "mc_token_ids": [], "mc_label": []}
        per_client = []
        pad_id = tok.convert_tokens_to_ids("<pad>")
        for key in sorted(groups):
            n_items = 0
            for d in groups[key]:
                persona_base = [tok.encode(s) for s in d["personality"]]
                utts = [
                    ([tok.encode(h) for h in
                      utt["history"][-(2 * self.max_history + 1):]],
                     [tok.encode(c) for c in utt["candidates"][-C:]])
                    for utt in d["utterances"]]
                # permutation p sees the persona sentences rotated by p
                for perm in range(permutations):
                    persona = persona_base[perm:] + persona_base[:perm]
                    for history, cands in utts:
                        self._append_item(rows, persona, history, cands,
                                          pad_id, C, S)
                        n_items += 1
            per_client.append(n_items)
        packed = {k: np.stack(v).astype(np.int32) for k, v in rows.items()}
        return packed, per_client

    def _append_item(self, rows, persona, history, cands, pad_id, C, S):
        ii = np.full((C, S), pad_id, np.int32)
        tt = np.full((C, S), pad_id, np.int32)
        ll = np.full((C, S), LM_IGNORE, np.int32)
        mc = np.zeros((C,), np.int32)
        for j, cand_ids in enumerate(cands):
            inst = build_input_from_segments(
                persona, history, cand_ids, self.tokenizer,
                lm_labels=j == len(cands) - 1)
            ids = inst["input_ids"][:S]
            ii[j, :len(ids)] = ids
            tt[j, :len(ids)] = inst["token_type_ids"][:S]
            ll[j, :len(ids)] = inst["lm_labels"][:S]
            mc[j] = len(ids) - 1
        rows["input_ids"].append(ii)
        rows["token_type_ids"].append(tt)
        rows["lm_labels"].append(ll)
        rows["mc_token_ids"].append(mc)
        rows["mc_label"].append(len(cands) - 1)

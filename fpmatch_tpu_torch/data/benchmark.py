"""Benchmark layer: serves image/keypoint pairs + ground-truth assignments.

The port's own copy of the JAX package's `data/benchmark.py` (host code:
numpy and the standard library only, so spawned loader workers can import
it), the same pair lists from the same index:

  * `get_data(ids)` loads images + keypoints, builds the GT permutation by
    keypoint-label equality with 'intersection'/'inclusion' filtering
    (benchmark.py:172-296);
  * matching task: all same-class image combinations;
  * classification task: genuine/imposter pair protocols —
      - self-pair protocol (each image with itself, augmented twice; one
        representative per finger crossed with every other finger —
        benchmark.py:127-170),
      - session protocol ({person}_{session}_{stance} ids: session1×session2
        genuine pairs, cross-person imposters — benchmark.py:465-505);
  * train-mode pair balancing, test-mode full enumeration.
"""
from __future__ import annotations

import itertools
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import (FingerprintDataset, L3SF, L3SFV2AugmentedDataset,
                      PolyUDBI, PolyUDBII)


class Benchmark:
    """Pair server over a FingerprintDataset."""

    def __init__(self, dataset: FingerprintDataset, *, filter="intersection",
                 pair_protocol: str = "self", seed: int = 123):
        self.dataset = dataset
        self.sets = dataset.sets
        self.task = dataset.task
        self.filter = filter
        self.pair_protocol = pair_protocol
        self.data_dict = dataset.load_index()
        self.classes = sorted({v["cls"] for v in self.data_dict.values()})
        self.seed = seed
        self.rng = random.Random(seed)
        self._classify_pairs: Optional[List[Tuple[str, str]]] = None

    # ----------------------------------------------------------------- io
    def get_path(self, img_id: str) -> str:
        return self.data_dict[img_id]["path"]

    def get_data(self, ids: Sequence[str], shuffle: bool = True):
        """Load annotations for `ids`; for the matching task also build GT
        permutations from label equality (intersection filter). Returns
        (data_list, perm_mat_dict, ids)."""
        ids = sorted(ids)
        data_list = []
        for key in ids:
            entry = self.data_dict[key]
            kpts = [dict(k) for k in entry["kpts"]]
            if shuffle:
                self.rng.shuffle(kpts)
            data_list.append({"kpts": kpts, "cls": entry["cls"],
                              "univ_size": entry["univ_size"],
                              "path": entry["path"]})

        if self.task == "classify":
            return data_list, {}, list(ids)

        perm_mat_dict = {}
        for (a, b) in itertools.combinations(range(len(ids)), 2):
            la = [k["labels"] for k in data_list[a]["kpts"]]
            lb = [k["labels"] for k in data_list[b]["kpts"]]
            common = set(la) & set(lb)
            if self.filter == "intersection":
                ia = [i for i, l in enumerate(la) if l in common]
                ib = [i for i, l in enumerate(lb) if l in common]
                data_list[a]["kpts"] = [data_list[a]["kpts"][i] for i in ia]
                data_list[b]["kpts"] = [data_list[b]["kpts"][i] for i in ib]
            elif self.filter == "inclusion":
                ia = [i for i, l in enumerate(la) if l in common]
                data_list[a]["kpts"] = [data_list[a]["kpts"][i] for i in ia]
            la = [k["labels"] for k in data_list[a]["kpts"]]
            lb = [k["labels"] for k in data_list[b]["kpts"]]
            perm = np.zeros((len(la), len(lb)), np.float32)
            pos_b = {l: j for j, l in enumerate(lb)}
            for i, l in enumerate(la):
                j = pos_b.get(l)
                if j is not None and l != "outlier":
                    perm[i, j] = 1
            perm_mat_dict[(a, b)] = perm
        return data_list, perm_mat_dict, list(ids)

    # ------------------------------------------------------------- pairing
    def finger_id(self, cls_name: str) -> str:
        return cls_name

    def _parse_session_id(self, img_id: str):
        """{prefix}_{person}_{session}_{stance} → (person, session, stance)."""
        parts = img_id.split("_")
        if len(parts) < 4:
            return None
        try:
            return ("_".join(parts[:-2]), int(parts[-2]), int(parts[-1]))
        except ValueError:
            return None

    def _sibling_partners(self) -> Dict[str, str]:
        """person -> partner person, from <dataset root>/siblings.json.

        The synthetic generator records sibling fingers (same canonical ridge
        field, independent pore layout — data/generator.py add_sibling_fingers)
        in a sidecar so the pair protocols can serve sibling↔partner pairs,
        the hard negatives of pore verification, with guaranteed coverage
        rather than leaving them to uniform impostor sampling (~0.5% odds)."""
        import json
        from pathlib import Path

        root = getattr(self.dataset, "root", None)
        if root is None:
            return {}
        f = Path(root) / "siblings.json"
        if not f.exists():
            return {}
        finger_map = json.loads(f.read_text())      # bare finger names
        persons = {v["cls"] for v in self.data_dict.values()}
        by_finger: Dict[str, str] = {}
        for p in persons:
            by_finger[p.split("_", 1)[1] if "_" in p else p] = p
        return {by_finger[s]: by_finger[t] for s, t in finger_map.items()
                if s in by_finger and t in by_finger}

    def _self_pairs(self) -> List[Tuple[str, str]]:
        groups = defaultdict(list)
        for k, v in self.data_dict.items():
            groups[self.finger_id(v["cls"])].append(k)
        genuine = [(i, i) for ids in groups.values() for i in ids]
        fids = [f for f in groups if groups[f]]
        imposter = [(groups[a][0], groups[b][0])
                    for a in fids for b in fids if a != b]
        hard = [(groups[a][0], groups[b][0])
                for a, b in self._sibling_partners().items() if groups.get(b)]
        return self._balance(genuine, imposter, hard)

    def _session_pairs(self) -> List[Tuple[str, str]]:
        parsed: Dict[str, Dict[int, Dict[int, str]]] = {}
        for img_id in self.data_dict:
            p = self._parse_session_id(img_id)
            if p is None:
                continue
            person, session, stance = p
            parsed.setdefault(person, {}).setdefault(session, {})[stance] = img_id
        genuine = []
        for person, sessions in parsed.items():
            if 1 in sessions and 2 in sessions:
                for id1 in sessions[1].values():
                    for id2 in sessions[2].values():
                        genuine.append((id1, id2))
        imposter = []
        persons = list(parsed)
        for i, pa in enumerate(persons):
            id_a = parsed[pa].get(1, {}).get(1)
            if id_a is None:
                continue
            for pb in persons[i + 1:]:
                id_b = parsed[pb].get(2, {}).get(1)
                if id_b is not None:
                    imposter.append((id_a, id_b))
                    id_a2 = parsed[pb].get(1, {}).get(1)
                    id_b2 = parsed[pa].get(2, {}).get(1)
                    if id_a2 is not None and id_b2 is not None:
                        imposter.append((id_a2, id_b2))
        # sibling↔partner: enumerate EVERY cross-session impression pair in
        # both directions (these carry the pore-constellation signal)
        hard = []
        for pa, pb in self._sibling_partners().items():
            if pa not in parsed or pb not in parsed:
                continue
            for x, y in ((pa, pb), (pb, pa)):
                for id1 in parsed[x].get(1, {}).values():
                    for id2 in parsed[y].get(2, {}).values():
                        hard.append((id1, id2))
        return self._balance(genuine, imposter, hard)

    def _balance(self, genuine, imposter, hard=()) -> List[Tuple[str, str]]:
        """test: full enumeration (+ the sibling hard pairs not already in
        it). train/val: guarantee every hard pair is served, fill the rest of
        the imposter half with a seeded SHUFFLE of the pool before truncating
        — an ordered truncation would draw all imposters from the first few
        persons of the index."""
        hard = list(dict.fromkeys(hard))
        if self.sets == "test":
            seen = set(imposter)
            return genuine + imposter + [p for p in hard if p not in seen]
        rng = random.Random(self.seed * 7_654_321 + 13)
        genuine = list(genuine)
        rest = [p for p in imposter if p not in set(hard)]
        rng.shuffle(genuine)
        rng.shuffle(rest)
        n = min(len(genuine), len(hard) + len(rest))
        return genuine[:n] + (hard + rest)[:n]

    def classify_pairs(self) -> List[Tuple[str, str]]:
        if self._classify_pairs is None:
            if self.pair_protocol == "session":
                self._classify_pairs = self._session_pairs()
            elif self.pair_protocol == "auto":
                # session pairs when image ids parse as
                # {person}_{session}_{stance} (multi-impression data: genuine
                # = cross-session, the hard protocol), else self pairs
                pairs = self._session_pairs()
                self._classify_pairs = pairs if pairs else self._self_pairs()
            else:
                self._classify_pairs = self._self_pairs()
        return self._classify_pairs

    def match_combinations(self, cls: Optional[str] = None
                           ) -> List[Tuple[str, str]]:
        """All within-class image pairs for the matching task."""
        by_cls = defaultdict(list)
        for k, v in self.data_dict.items():
            by_cls[v["cls"]].append(k)
        out = []
        for c, ids in sorted(by_cls.items()):
            if cls is not None and c != cls:
                continue
            if len(ids) >= 2:
                out.extend(itertools.combinations(sorted(ids), 2))
            else:
                out.extend((i, i) for i in ids)
        return out

    def is_genuine(self, id_a: str, id_b: str) -> bool:
        ca = self.finger_id(self.data_dict[id_a]["cls"])
        cb = self.finger_id(self.data_dict[id_b]["cls"])
        return ca == cb


def make_benchmark(name: str, sets: str, root: Optional[str] = None,
                   task: str = "match", **kw) -> Benchmark:
    """Factory over the four dataset families (reference names preserved)."""
    classes = {
        "L3SFV2Augmented": (L3SFV2AugmentedDataset, "auto"),
        "Synthetic": (L3SFV2AugmentedDataset, "auto"),
        "PolyUDBII": (PolyUDBII, "session"),
        "PolyUDBI": (PolyUDBI, "session"),
        "L3SF": (L3SF, "session"),
    }
    if name not in classes:
        raise ValueError(f"unknown benchmark {name}; options: {list(classes)}")
    ds_cls, protocol = classes[name]
    ds_kw = {"task": task}
    if root is not None:
        ds_kw["root"] = root
    if "output_dir" in kw:                     # index-cache location
        ds_kw["output_dir"] = kw.pop("output_dir")
    ds = ds_cls(sets, **ds_kw)
    ds.build_index()
    return Benchmark(ds, pair_protocol=protocol, **kw)

"""Instruction / annotation loading for all supported datasets.

Parity with ``finetune_src/r2r/data_utils.py:26-83`` (R2R family + RxR),
``finetune_src/reverie/data_utils.py:45-88`` and ``finetune_src/cvdn/
main.py:24-31``. One output item per (path, instruction) with
pre-tokenized ``instr_encoding`` clipped to ``max_instr_len``.

A copy of ``vln_hamt_tpu/data/instructions.py`` (json only); the tests
hold the two equal on files they write.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _read_jsonl(path: str):
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                items.append(json.loads(line))
    return items


def load_instr_datasets(anno_dir: str, dataset: str, splits: Sequence[str],
                        tokenizer: str = "bert") -> List[dict]:
    """Raw per-split annotation loading (data_utils.py:26-54).

    A split containing '/' is treated as a path to augmented data.
    ``tokenizer`` selects the REVERIE annotation variant
    (reverie/data_utils.py:49-53: 'bert' -> ``REVERIE_{split}_enc.json``,
    'xlm' -> ``REVERIE_{split}_enc_xlmr.json``).
    """
    data: List[dict] = []
    for split in splits:
        if "/" in split:  # augmented data file path
            data += _read_json(split)
            continue
        if dataset == "r2r":
            data += _read_json(os.path.join(anno_dir, f"R2R_{split}_enc.json"))
        elif dataset == "r2r_last":
            data += _read_json(os.path.join(anno_dir, "LastSent", f"R2R_{split}_enc.json"))
        elif dataset == "r2r_back":
            data += _read_json(os.path.join(anno_dir, "ReturnBack", f"R2R_{split}_enc.json"))
        elif dataset == "r4r":
            data += _read_json(os.path.join(anno_dir, f"R4R_{split}_enc.json"))
        elif dataset == "rxr":
            data += _read_jsonl(os.path.join(anno_dir, f"rxr_{split}_guide_enc_xlmr.jsonl"))
        elif dataset == "reverie":
            if tokenizer == "xlm":
                data += _read_json(
                    os.path.join(anno_dir, f"REVERIE_{split}_enc_xlmr.json"))
            elif tokenizer == "bert":
                data += _read_json(os.path.join(anno_dir, f"REVERIE_{split}_enc.json"))
            else:
                raise ValueError(f"unsupported REVERIE tokenizer {tokenizer!r}")
        elif dataset == "cvdn":
            data += _read_json(os.path.join(anno_dir, f"{split}_enc.json"))
        else:
            raise ValueError(f"unknown dataset {dataset!r}")
    return data


def construct_instrs(
    anno_dir: str,
    dataset: str,
    splits: Sequence[str],
    max_instr_len: int = 512,
    tokenizer: str = "bert",
) -> List[dict]:
    """One entry per (path, instruction) (data_utils.py:56-83).

    Per-dataset annotation semantics (each matching its reference
    loader exactly):

    - RxR items are already per-instruction (``data_utils.py:59-67``).
    - CVDN/NDH items stay UNEXPANDED — they carry a single pre-encoded
      dialog ``instr_encoding`` which is clipped from the TAIL so the
      most recent dialog turns survive (``cvdn/main.py:24-31``:
      ``item['instr_encoding'][-max_instr_len:]``).
    - REVERIE ids are ``{path_id}_{objId}_{j}``; test-split items have
      no ``objId`` and fall back to ``path_id = item['id']`` with
      ``objId = None`` (``reverie/data_utils.py:66-77``).
    - The R2R family expands the ``instructions``/``instr_encodings``
      lists with head clipping (``data_utils.py:68-82``).
    """
    out: List[dict] = []
    for item in load_instr_datasets(anno_dir, dataset, splits, tokenizer):
        if dataset == "rxr":
            new_item = dict(item)
            if "path_id" in item:
                new_item["instr_id"] = f"{item['path_id']}_{item['instruction_id']}"
            else:  # test split
                new_item["path_id"] = new_item["instr_id"] = str(item["instruction_id"])
            new_item["instr_encoding"] = item["instr_encoding"][:max_instr_len]
            out.append(new_item)
        elif dataset == "cvdn":
            new_item = dict(item)
            new_item["instr_encoding"] = item["instr_encoding"][-max_instr_len:]
            out.append(new_item)
        else:
            for j, instr in enumerate(item["instructions"]):
                new_item = dict(item)
                if dataset == "reverie":
                    if "objId" in item:
                        new_item["instr_id"] = (
                            f"{item['path_id']}_{item['objId']}_{j}")
                    else:  # test split: no object annotation
                        new_item["path_id"] = item["id"]
                        new_item["instr_id"] = f"{item['id']}_{j}"
                        new_item["objId"] = None
                else:
                    new_item["instr_id"] = f"{item['path_id']}_{j}"
                new_item["instruction"] = instr
                new_item["instr_encoding"] = item["instr_encodings"][j][:max_instr_len]
                del new_item["instructions"]
                del new_item["instr_encodings"]
                out.append(new_item)
    return out

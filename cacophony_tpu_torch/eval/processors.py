"""Dataset adapters (a copy of cacophony_tpu/eval/processors.py): same
on-disk formats as the reference's six processors
(src/eval/dataset_processors.py), same return contract —
(filepaths, {audio_name: {'description': [captions]}}, synthetic_dict) —
restructured: metadata is read ONCE per dataset (the reference re-reads the
Clotho caption CSV for every file), paths come from env-overridable configs
instead of hardcoded absolute directories (eval_dataset_configs.py:4-37).
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import json
import os
from abc import ABC, abstractmethod
from typing import Dict, List, Tuple

DATA_ROOT = os.environ.get("CACOPHONY_DATA_DIR", "dataset")


def _root(name: str, default_subdir: str) -> str:
    return os.environ.get(f"CACOPHONY_{name}_DIR",
                          os.path.join(DATA_ROOT, default_subdir))


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    data_dir: str
    sampling_rate: int


def _stem(path: str) -> str:
    return os.path.basename(path).split(".wav")[0]


class DatasetProcessor(ABC):
    """Returns (filepaths, text_dict, synthetic_text_dict)."""

    config: DatasetConfig

    @abstractmethod
    def get_filepaths_and_descriptions(
        self, current_split: str = ""
    ) -> Tuple[List[str], Dict, Dict]:
        ...


class ESC50Processor(DatasetProcessor):
    """ESC-50: audio/<fold wavs>, labels in esc50.csv col 'category'."""

    def __init__(self, data_dir: str = None, sampling_rate: int = 44_100):
        self.config = DatasetConfig(data_dir or _root("ESC50", "ESC-50-master"),
                                    sampling_rate)

    def get_filepaths_and_descriptions(self, current_split: str = ""):
        d = self.config.data_dir
        labels = {}
        with open(os.path.join(d, "esc50.csv")) as f:
            reader = csv.DictReader(f)
            for row in reader:
                labels[_stem(row["filename"])] = row["category"]
        files, text = [], {}
        for path in sorted(glob.glob(os.path.join(d, "*", "*.wav"))):
            name = _stem(path)
            if name in labels:
                files.append(path)
                text[name] = {"description": [labels[name]]}
        return files, text, {}


class US8KProcessor(DatasetProcessor):
    """UrbanSound8K: fold*/ wavs, metadata/UrbanSound8K.csv, class names with
    underscores replaced by spaces (reference :38)."""

    def __init__(self, data_dir: str = None, sampling_rate: int = 44_100):
        self.config = DatasetConfig(data_dir or _root("US8K", "UrbanSound8K"),
                                    sampling_rate)

    def get_filepaths_and_descriptions(self, current_split: str = ""):
        d = self.config.data_dir
        labels = {}
        with open(os.path.join(d, "metadata", "UrbanSound8K.csv")) as f:
            reader = csv.reader(f)
            header = next(reader)
            for row in reader:
                labels[_stem(row[0])] = row[-1].replace("_", " ")
        files, text = [], {}
        for path in sorted(glob.glob(os.path.join(d, "**", "*.wav"), recursive=True)):
            name = _stem(path)
            if name in labels:
                files.append(path)
                text[name] = {"description": [labels[name]]}
        return files, text, {}


class VGGSoundProcessor(DatasetProcessor):
    """VGGSound: test/*.wav + vggsound_full.json {clip: label}."""

    def __init__(self, data_dir: str = None, sampling_rate: int = 48_000):
        self.config = DatasetConfig(data_dir or _root("VGGSOUND", "vggsound"),
                                    sampling_rate)

    def get_filepaths_and_descriptions(self, current_split: str = "test"):
        d = self.config.data_dir
        with open(os.path.join(d, "vggsound_full.json")) as f:
            meta = json.load(f)
        files, text = [], {}
        for path in sorted(glob.glob(os.path.join(d, "test", "*.wav"))):
            name = _stem(path)
            if name in meta:
                files.append(path)
                text[name] = {"description": [meta[name]]}
        return files, text, {}


class TUTAS2017Processor(DatasetProcessor):
    """TUT Acoustic Scenes 2017: {train,eval}/*.wav + meta_{train,eval}.json
    keyed by '<name>.wav'."""

    def __init__(self, data_dir: str = None, sampling_rate: int = 44_100):
        self.config = DatasetConfig(
            data_dir or _root("TUTAS2017", "TUT_Acoustic_scenes_2017"),
            sampling_rate)

    def get_filepaths_and_descriptions(self, current_split: str = ""):
        d = self.config.data_dir
        meta = {}
        for split_name in ["train", "eval"]:
            p = os.path.join(d, f"meta_{split_name}.json")
            if os.path.exists(p):
                with open(p) as f:
                    meta[split_name] = json.load(f)
        files, text = [], {}
        for path in sorted(glob.glob(os.path.join(d, "*", "*.wav"))):
            split_name = os.path.basename(os.path.dirname(path))
            ref = meta.get("train" if split_name == "train" else "eval", {})
            key = os.path.basename(path)
            if key in ref:
                files.append(path)
                text[_stem(path)] = {"description": [ref[key]]}
        return files, text, {}


class AudioCaps16kProcessor(DatasetProcessor):
    """AudioCaps @16k: {split}/*.wav + {split}.csv (clip id col 1, caption
    last col; multiple rows per clip = multiple captions)."""

    def __init__(self, data_dir: str = None, sampling_rate: int = 16_000):
        self.config = DatasetConfig(data_dir or _root("AUDIOCAPS", "audiocaps"),
                                    sampling_rate)

    def get_filepaths_and_descriptions(self, current_split: str = "test"):
        d = self.config.data_dir
        captions: Dict[str, List[str]] = {}
        with open(os.path.join(d, f"{current_split}.csv")) as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                captions.setdefault(row[1], []).append(row[-1])
        files, text = [], {}
        for path in sorted(glob.glob(os.path.join(d, current_split, "*.wav"))):
            name = _stem(path)
            if name in captions:
                files.append(path)
                text[name] = {"description": captions[name]}
        return files, text, {}


class Clotho16kProcessor(DatasetProcessor):
    """Clotho v2 @16k: {split}/*.wav + clotho_captions_{split}.csv with
    columns file_name, caption_1..caption_5 (5 captions per clip)."""

    def __init__(self, data_dir: str = None, sampling_rate: int = 16_000):
        self.config = DatasetConfig(
            data_dir or _root("CLOTHO16K", "clotho_audio_evaluation_16k"),
            sampling_rate)

    def get_filepaths_and_descriptions(self, current_split: str = "evaluation"):
        d = self.config.data_dir
        captions: Dict[str, List[str]] = {}
        cap_path = os.path.join(d, f"clotho_captions_{current_split}.csv")
        with open(cap_path, newline="") as f:
            for row in csv.DictReader(f):
                captions[row["file_name"]] = [
                    row[f"caption_{i}"] for i in range(1, 6) if row.get(f"caption_{i}")
                ]
        files, text = [], {}
        for path in sorted(glob.glob(os.path.join(d, current_split, "*.wav"))):
            fname = os.path.basename(path)
            if fname in captions:
                files.append(path)
                text[_stem(path)] = {"description": captions[fname]}
        return files, text, {}


PROCESSORS = {
    "esc50": ESC50Processor,
    "us8k": US8KProcessor,
    "vggsound": VGGSoundProcessor,
    "tutas2017": TUTAS2017Processor,
    "audiocaps": AudioCaps16kProcessor,
    "clotho": Clotho16kProcessor,
}

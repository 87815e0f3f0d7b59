"""HEAR embedding-extraction runner (cacophony_tpu/hear/runner.py).

CLI equivalent of the reference's click runner
(src/eval/heareval/embeddings/runner.py): per HEAR task directory, embed
every split's clips and write the memmapped embedding store; idempotent via
`.done.embeddings` markers; wall-time recorded to profile.embeddings.json.

Task directory layout (HEAR standard, consumed identically by the
reference): task_metadata.json (splits, embedding_type, prediction_type),
labelvocabulary.csv, {split}.json, audio at <task>/<sample_rate>/<split>/.
The model runs on `device`: the card unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

from cacophony_tpu_torch.checkpoints.io import load_audiomae, load_caco
from cacophony_tpu_torch.hear.embeddings import (
    AudioMAEHearEmbedder,
    CacoHearEmbedder,
    labels_for_timestamps,
    memmap_split,
    save_event,
    save_scene,
)


def _make_embedder(name: str, model_path: str, sample_rate: int,
                   audio_max_len_s: float, batch_size: int,
                   strict_counts: bool = True, device="cuda"):
    if "audiomae" in name:
        cfg, params = load_audiomae(model_path, strict_counts=strict_counts,
                                    device=device)
        return AudioMAEHearEmbedder(cfg, params, sample_rate=sample_rate,
                                    audio_max_len_s=audio_max_len_s,
                                    batch_size=batch_size)
    cfg, params = load_caco(model_path, strict_counts=strict_counts, device=device)
    return CacoHearEmbedder(cfg, params, sample_rate=sample_rate,
                            audio_max_len_s=audio_max_len_s,
                            batch_size=batch_size)


def task_embeddings(embedder, task_path: Path, embed_task_dir: Path):
    metadata = json.loads((task_path / "task_metadata.json").read_text())
    embed_task_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(task_path / "task_metadata.json", embed_task_dir)
    shutil.copy(task_path / "labelvocabulary.csv", embed_task_dir)

    for split in metadata["splits"]:
        split_path = task_path / f"{split}.json"
        shutil.copy(split_path, embed_task_dir)
        split_data = json.loads(split_path.read_text())
        audio_dir = task_path / str(embedder.sample_rate) / split
        outdir = embed_task_dir / split
        outdir.mkdir(parents=True, exist_ok=True)

        names = list(split_data)
        bs = embedder.batch_size
        for i in range(0, len(names), bs):
            chunk = names[i:i + bs]
            paths = [str(audio_dir / n) for n in chunk]
            labels = [split_data[n] for n in chunk]
            if metadata["embedding_type"] == "event":
                emb, ts = embedder.event_embeddings(paths)
                ts_labels = labels_for_timestamps(labels, ts)
                save_event(str(outdir), chunk, emb, ts, ts_labels)
            else:
                emb = embedder.scene_embeddings(paths)
                save_scene(str(outdir), chunk, emb, labels)

        memmap_split(str(outdir), str(embed_task_dir), split, split_data,
                     metadata["embedding_type"])


def run(model_path: str, tasks_dir: str, embeddings_dir: str,
        embedding_name: str = "caco", task: str = "all",
        batch_size: int = 8, max_audio_len_s: float = 10.0,
        sample_rate: int = 16_000, strict_counts: bool = True, device="cuda"):
    tasks_root = Path(tasks_dir)
    if task == "all":
        tasks = sorted(p for p in tasks_root.iterdir() if p.is_dir())
    else:
        tasks = [tasks_root / task]

    embedder = _make_embedder(embedding_name, model_path, sample_rate,
                              max_audio_len_s, batch_size, strict_counts, device)
    for task_path in tasks:
        embed_task_dir = Path(embeddings_dir) / embedding_name / task_path.name
        done = embed_task_dir / ".done.embeddings"
        if done.exists():
            print(f"skip {task_path.name} (done)")
            continue
        if embed_task_dir.exists():
            shutil.rmtree(embed_task_dir)
        t0 = time.time()
        task_embeddings(embedder, task_path, embed_task_dir)
        elapsed = time.time() - t0
        (embed_task_dir / "profile.embeddings.json").write_text(
            json.dumps({"time_elapsed": elapsed}, indent=4))
        done.write_text("")
        print(f"{task_path.name}: embeddings in {elapsed:.1f}s")


def main(argv=None):
    p = argparse.ArgumentParser("cacophony_tpu_torch.hear.runner")
    p.add_argument("--model-path", required=True)
    p.add_argument("--tasks-dir", default="tasks")
    p.add_argument("--task", default="all")
    p.add_argument("--embedding-name", default="caco")
    p.add_argument("--embeddings-dir", default="embeddings")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-audio-len", type=float, default=10.0,
                   help="seconds (the reference flag is in samples)")
    p.add_argument("--sample-rate", type=int, default=16_000)
    p.add_argument("--no-strict-counts", action="store_true",
                   help="skip published param-count checks (custom models)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cuda, or cpu)")
    a = p.parse_args(argv)
    run(a.model_path, a.tasks_dir, a.embeddings_dir, a.embedding_name, a.task,
        a.batch_size, a.max_audio_len, a.sample_rate,
        strict_counts=not a.no_strict_counts, device=a.device)


if __name__ == "__main__":
    main()

"""The data pipeline for one process: copies of ``_host_index_stream``,
``batch_iterator``, ``_prefetched``, ``skip_batches_for_samples``,
``_build_dataset`` and ``load_data_from_args`` from
``distributed_pipeline_tpu/data/__init__.py``.

The same seed gives the JAX loader's batches in the same order: an infinite
stream of fixed-shape ``[batch_size, seq_len]`` numpy batches, reshuffled
each epoch from a fold of the seed, optionally assembled by background
threads (the delivered order does not depend on their scheduling), and
fast-forwarded in O(1) by ``skip_batches`` so a resumed run sees exactly
the batches an uninterrupted one would have. Under several processes each
rank streams its own shard: rank r takes ``order[r::P]`` of every epoch's
order, trimmed so every rank gets the same count (``load_data_from_args``
reads the rank from ``parallel/dist.py``, or takes a data group's
``shard``; ``host_sharded=False`` gives every rank the same stream).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from .dataset import (JsonlSeq2SeqDataset, SyntheticLMDataset,
                      SyntheticSeq2SeqDataset)

__all__ = ["load_data_from_args", "batch_iterator",
           "skip_batches_for_samples", "SyntheticLMDataset",
           "SyntheticSeq2SeqDataset", "JsonlSeq2SeqDataset", "LM_DATASETS"]

# dataset names that select the synthetic causal-LM stream; any other name
# selects the synthetic seq2seq stream (the JAX package's rule)
LM_DATASETS = ("synthetic-lm", "lm", "gpt2")


def skip_batches_for_samples(consumed_samples: int, batch_size: int,
                             process_count: int = 1) -> int:
    """Batches of this rank's ``batch_size`` to skip so the stream lands
    after ``consumed_samples`` GLOBAL examples (global batch = ``batch_size
    * process_count``; rounding down): the position that survives a change
    of world size."""
    gb = batch_size * max(process_count, 1)
    if gb <= 0:
        raise ValueError(f"global batch must be positive, got {gb}")
    return max(0, int(consumed_samples)) // gb


def _host_index_stream(n_items: int, *, shuffle: bool, seed: int,
                       loop: bool, skip_items: int = 0,
                       process_index: int = 0, process_count: int = 1
                       ) -> Iterator[int]:
    """This rank's slice of the (optionally shuffled) index sequence,
    epochs reshuffled with a different fold of the seed: rank r takes
    ``order[r::P][:n // P]``, so every rank yields the same count (a rank
    with one more batch would desynchronize the collectives).
    ``skip_items`` (this rank's items) jumps whole epochs arithmetically
    and slices only the first yielded one."""
    per_rank = n_items // process_count
    if per_rank == 0:
        raise ValueError(f"dataset of {n_items} items cannot feed "
                         f"{process_count} ranks (at least one item per "
                         f"rank per epoch)")
    epoch = skip_items // per_rank
    offset = skip_items % per_rank
    if not loop and epoch > 0:
        return
    while True:
        if shuffle:
            order = np.random.default_rng(
                (seed * 0x51ED2701 + epoch) & 0xFFFFFFFFFFFFFFFF
            ).permutation(n_items)
        else:
            order = np.arange(n_items)
        sl = order[process_index::process_count][:per_rank]
        yield from sl[offset:].tolist()
        offset = 0
        if not loop:
            return
        epoch += 1


def batch_iterator(dataset: Any, batch_size: int, *, shuffle: bool = True,
                   seed: int = 0, loop: bool = True, process_index: int = 0,
                   process_count: int = 1, num_workers: int = 0,
                   prefetch: int = 4, skip_batches: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape batches of rank ``process_index``'s shard of any
    ``__len__``/``__getitem__`` dataset, optionally thread-prefetched;
    ``skip_batches`` fast-forwards in O(1)."""
    n = len(dataset)
    if n < batch_size * process_count and not loop:
        raise ValueError(f"dataset of {n} items cannot fill one global "
                         f"batch of {batch_size}x{process_count} without "
                         f"looping")

    def gen(worker_id: int = 0, stride: int = 1
            ) -> Iterator[Dict[str, np.ndarray]]:
        """Every ``stride``-th batch from ``worker_id``: skipped batches
        consume indices only, so N producers split the work while the
        interleaved stream equals the single-producer one."""
        idx_stream = _host_index_stream(
            n, shuffle=shuffle, seed=seed, loop=loop,
            skip_items=skip_batches * batch_size,
            process_index=process_index, process_count=process_count)
        b = skip_batches
        while True:
            mine = b % stride == worker_id
            taken = 0
            items = []
            for idx in idx_stream:
                taken += 1
                if mine:
                    items.append(dataset[idx])
                if taken == batch_size:
                    break
            if taken < batch_size:
                return  # non-loop tail: drop the ragged batch
            if mine:
                yield {k: np.stack([it[k] for it in items])
                       for k in items[0]}
            b += 1

    if num_workers <= 0:
        return gen()
    return _prefetched(gen, num_workers=num_workers, depth=prefetch,
                       start_batch=skip_batches)


def _prefetched(gen_factory, *, num_workers: int, depth: int,
                start_batch: int = 0) -> Iterator:
    """``num_workers`` producer threads, each materializing its
    ``worker_id :: num_workers`` stripe; the consumer round-robins their
    queues from ``start_batch``'s worker, so the order equals the
    single-producer stream. Closing the iterator stops the producers."""
    _END = object()
    stop = threading.Event()
    queues = [queue.Queue(maxsize=max(1, depth)) for _ in range(num_workers)]

    def _put(q: "queue.Queue", item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker(wid: int) -> None:
        q = queues[wid]
        try:
            for batch in gen_factory(worker_id=wid, stride=num_workers):
                if not _put(q, batch):
                    return
            _put(q, _END)
        except BaseException as e:  # handed to the consumer, re-raised there
            _put(q, e)

    for wid in range(num_workers):
        threading.Thread(target=worker, args=(wid,), daemon=True).start()
    try:
        b = start_batch
        while True:
            item = queues[b % num_workers].get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
            b += 1
    finally:
        stop.set()


def _build_dataset(dataset: str, data_dir: str, split: str, *, seq_len: int,
                   vocab_size: int, seed: int) -> Any:
    """The jsonl corpus when ``data_dir`` is given, else a synthetic
    stream: causal-LM for the LM names, seq2seq for any other. The
    validation stream draws from a disjoint fold of the seed."""
    if data_dir:
        return JsonlSeq2SeqDataset(data_dir, split, seq_len=seq_len,
                                   vocab_size=vocab_size)
    fold = seed if split == "train" else seed + 7919
    if dataset in LM_DATASETS:
        return SyntheticLMDataset(seq_len=seq_len, vocab_size=vocab_size,
                                  seed=fold)
    return SyntheticSeq2SeqDataset(seq_len=seq_len, vocab_size=vocab_size,
                                   seed=fold)


def load_data_from_args(split: str = "train", data_dir: str = "",
                        batch_size: int = 1, deterministic: bool = False,
                        loop: bool = True, num_loader_proc: int = 0, *,
                        dataset: str = "synthetic-seq2seq",
                        seq_len: int = 128, vocab_size: int = 8192,
                        seed: int = 0, data_loader_workers: int = 0,
                        host_sharded: bool = True, skip_batches: int = 0,
                        shard: Optional[Tuple[int, int]] = None,
                        **_unused: Any) -> Iterator[Dict[str, np.ndarray]]:
    """The JAX package's loader entry point: the batches of ``split``
    (``_build_dataset``), shuffled unless ``deterministic``, looped unless
    ``loop`` is false, assembled by ``num_loader_proc`` (or
    ``data_loader_workers``) threads, fast-forwarded by ``skip_batches``.
    ``batch_size`` is per rank, and each rank streams its shard
    (``parallel/dist.py``'s rank and world size, or ``shard`` =
    ``(index, count)``: under sequence parallelism the data group's, so
    the sequence ranks of a group read the same rows);
    ``host_sharded=False`` gives every rank the same stream (the
    eval-decode callback's batch)."""
    from ..parallel import dist
    ds = _build_dataset(dataset, data_dir, split, seq_len=seq_len,
                        vocab_size=vocab_size, seed=seed)
    if shard is None:
        shard = (dist.get_rank(), dist.get_world_size())
    return batch_iterator(
        ds, batch_size, shuffle=not deterministic, seed=seed, loop=loop,
        process_index=shard[0] if host_sharded else 0,
        process_count=shard[1] if host_sharded else 1,
        num_workers=max(num_loader_proc, data_loader_workers),
        skip_batches=skip_batches)

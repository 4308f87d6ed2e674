"""Disaggregated prefill/decode serving over the StageLink transport: the
port of ``distributed_pipeline_tpu/mpmd/disagg.py``.

Prefill and decode have opposite resource shapes — prefill is one big
compute-bound forward over the prompt, decode is many tiny memory-bound
steps — so serving them on the same slots means a prefill burst stalls
every in-flight decode for the length of the prompt forward. The
disaggregated topology runs them in DIFFERENT processes and moves the only
state that must cross — the prompt's paged K/V pages and the first picked
token — over a :class:`.link.StageLink`:

* :class:`PrefillClient` — a prefill-only wrapper over
  :class:`..serving.engine.DecodeEngine`: runs the prompt forward on a
  single scratch slot, pulls the written pages out with
  ``extract_pages``, frees them, and hands back a wire payload;
* :func:`pack_kv_frame` / :func:`unpack_kv_frame` — THE wire format for
  one transferred request (prompt + per-layer pool rows + metadata), the
  JAX package's: the same ``kv:`` array keys and meta fields;
* the receiving side is ``DecodeServer.submit_prefilled`` — immediate
  all-or-nothing admission that scatters the transferred pages into the
  local pool (``ingest_pages``) and seeds the slot's token/position; a
  ``None`` return (no slot / no pages) pushes backpressure onto the link;
* :func:`serve_disagg_inprocess` — both roles in one process over a
  :class:`.link.MemStageLink`: the token-identity harness and the
  smallest runnable example of the topology.

Page-id remapping: the payload's rows are POSITIONAL (row i = logical page
i of the prompt), so the prefill side's physical page ids never leave its
process — the decode side scatters the rows at ids from its OWN allocator.
The engines must agree on model config, ``page_size``, ``max_prompt_len``
and ``max_len`` (same padded shapes => same masked softmax => greedy token
identity); ``ingest_pages`` refuses a payload whose pool keys or row shapes
differ.

This module imports torch: it is the WORKER side.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .link import MemStageLink, StageLink

__all__ = ["PrefillClient", "pack_kv_frame", "unpack_kv_frame",
           "serve_disagg_inprocess"]

_KV_PREFIX = "kv:"


class PrefillClient:
    """Prefill-only engine wrapper: prompt in, transferable KV out.

    Owns a 1-slot :class:`..serving.engine.DecodeEngine` whose page pool
    covers exactly one worst-case prompt (plus the trash page) and a
    private :class:`..serving.paged_kv.PageManager` for it. Each
    :meth:`prefill` call allocates the prompt's pages, runs the prefill
    phase (one shape every call, so on the card one CUDA graph captured at
    the first call and replayed), extracts the written pages to host
    arrays, and frees the pages for the next call.

    Geometry (``page_size``/``max_prompt_len``/``max_len``) must match the
    decode side: identical padded shapes make the masked softmax identical
    to a colocated prefill, which greedy token identity rests on.
    """

    def __init__(self, model, *, page_size: int, max_prompt_len: int,
                 max_len: int, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 decode_impl: str = "auto", cuda_graphs: bool = True
                 ) -> None:
        from ..serving.engine import DecodeEngine
        from ..serving.paged_kv import PageManager

        n_prompt_pages = -(-max_prompt_len // page_size)
        self.engine = DecodeEngine(
            model, decode_slots=1, page_size=page_size,
            max_pages=n_prompt_pages + 1, max_prompt_len=max_prompt_len,
            max_len=max_len, prefill_batch=1, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed, decode_impl=decode_impl,
            cuda_graphs=cuda_graphs)
        self.mgr = PageManager(n_prompt_pages + 1, page_size)
        self.prefills = 0
        self.prompt_tokens = 0

    def warmup(self) -> None:
        """Run (and on the card capture) the prefill phase before serving:
        the first routed request's TTFT must be service time, not capture
        time."""
        self.prefill(np.full((2,), 4, np.int32))
        self.prefills = 0
        self.prompt_tokens = 0

    def prefill(self, prompt: np.ndarray) -> Dict[str, object]:
        """Run one prompt through the prefill phase and return
        ``{"first_token", "kv"}`` — the picked continuation token and the
        positional page payload (``DecodeEngine.extract_pages`` format).
        Raises ``ValueError`` on an out-of-range prompt (the validation
        ``DecodeServer.submit`` has, so the fleet worker can reject a bad
        request before shipping anything)."""
        from ..serving.paged_kv import TRASH_PAGE

        prompt = np.ascontiguousarray(prompt, np.int32).ravel()
        plen = int(prompt.shape[0])
        if not 1 <= plen <= self.engine.max_prompt_len:
            raise ValueError(
                f"prompt length {plen} outside [1, "
                f"max_prompt_len={self.engine.max_prompt_len}]")
        pages = self.mgr.alloc(self.mgr.pages_for(plen))
        if pages is None:  # unreachable by construction (pool = 1 prompt)
            raise RuntimeError("prefill page pool exhausted")
        ids = np.zeros((1, self.engine.max_prompt_len), np.int32)
        ids[0, :plen] = prompt
        stables = np.full((1, self.engine.pages_per_slot), TRASH_PAGE,
                          np.int32)
        stables[0, :len(pages)] = pages
        toks = self.engine.prefill(ids, np.asarray([plen], np.int32),
                                   np.asarray([0], np.int32), stables)
        first = int(toks[0].item())
        kv = self.engine.extract_pages(pages)
        self.mgr.free(pages)
        self.prefills += 1
        self.prompt_tokens += plen
        return {"first_token": first, "kv": kv}


def pack_kv_frame(req_id: int, prompt: np.ndarray, max_new_tokens: int,
                  prefilled: Dict[str, object], *,
                  src: int = 0, submit_t: float = 0.0,
                  ttft_s: Optional[float] = None,
                  trace: Optional[str] = None
                  ) -> Tuple[Dict[str, np.ndarray], dict]:
    """One transferred request as a StageLink ``(arrays, meta)`` frame.

    ``prefilled`` is a :meth:`PrefillClient.prefill` result. ``src`` is
    the sending prefill worker's id (the decode worker answers on that
    worker's tok link); ``ttft_s`` is computed ON THE PREFILL SIDE (the
    first token exists the moment prefill completes) and rides the frame
    so the reply can carry it back to the router untouched."""
    arrays = {"prompt": np.ascontiguousarray(prompt, np.int32)}
    for key, rows in prefilled["kv"].items():
        arrays[_KV_PREFIX + key] = rows
    meta = {"op": "kv", "id": int(req_id),
            "max_new_tokens": int(max_new_tokens),
            "first_token": int(prefilled["first_token"]),
            "src": int(src), "submit_t": float(submit_t)}
    if ttft_s is not None:
        meta["ttft_s"] = float(ttft_s)
    if trace is not None:
        meta["trace"] = trace
    return arrays, meta


def unpack_kv_frame(arrays: Dict[str, np.ndarray], meta: dict) -> dict:
    """Invert :func:`pack_kv_frame`: ``{"id", "prompt", "max_new_tokens",
    "first_token", "kv", "src", "submit_t", ...}``."""
    kv = {key[len(_KV_PREFIX):]: rows for key, rows in arrays.items()
          if key.startswith(_KV_PREFIX)}
    return {**meta, "prompt": arrays["prompt"], "kv": kv}


def serve_disagg_inprocess(model, pairs: Sequence[Tuple[np.ndarray, int]],
                           *, decode_slots: int = 4, page_size: int = 0,
                           max_prompt_len: int = 0, max_len: int = 0,
                           max_pages: int = 0, decode_span: int = 1,
                           eos_id: Optional[int] = None,
                           link: Optional[StageLink] = None,
                           server=None, device=None) -> List[dict]:
    """Both disaggregation roles in one process, stitched by a real
    StageLink frame per request: prefill every prompt up front (the
    burst), then admit-with-backpressure on the decode side and run the
    decode loop to completion. Returns one ``{"id", "tokens",
    "prompt_len"}`` dict per request, in submission order — ``tokens``
    includes the transferred first token, exactly what the colocated
    ``DecodeServer`` yields for the same prompts.

    ``link`` defaults to a :class:`MemStageLink` sized for the whole
    burst; pass a capacity-limited one to exercise backpressure. Pass
    ``server`` to reuse a built :class:`..serving.scheduler.DecodeServer`
    (``device`` then follows it)."""
    from ..serving.scheduler import DecodeServer

    max_len = max_len or model.seq_len
    max_prompt_len = max_prompt_len or max(2, max_len // 2)
    page_size = page_size or 16
    if server is None:
        server = DecodeServer(
            model, decode_slots=decode_slots, page_size=page_size,
            max_pages=max_pages, max_prompt_len=max_prompt_len,
            max_len=max_len, decode_span=decode_span, eos_id=eos_id,
            device=device)
    # the server has placed the model on its device
    pre = PrefillClient(server.model, page_size=page_size,
                        max_prompt_len=max_prompt_len, max_len=max_len)
    if link is None:
        link = MemStageLink(capacity=len(pairs) + 1)

    # prefill side: the whole burst crosses the link first
    for i, (prompt, mnt) in enumerate(pairs):
        out = pre.prefill(prompt)
        arrays, meta = pack_kv_frame(i, prompt, mnt, out)
        link.send(arrays, meta)

    # decode side: admit when capacity allows, step the scheduler, repeat
    results: Dict[int, object] = {}
    held = None
    while True:
        if held is None:
            held = link.recv(timeout_s=0.0)
        if held is not None:
            req = unpack_kv_frame(*held)
            admitted = server.submit_prefilled(
                req["prompt"], req["max_new_tokens"],
                first_token=req["first_token"], kv_pages=req["kv"])
            if admitted is not None:
                results[req["id"]] = admitted
                held = None  # else: backpressure — retry after a step
        if held is None and link.pending() == 0 and not server.busy:
            break
        server.step()
    server.drain()
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    return [{"id": i, "tokens": list(results[i].tokens),
             "prompt_len": int(results[i].prompt_len)}
            for i in sorted(results)]

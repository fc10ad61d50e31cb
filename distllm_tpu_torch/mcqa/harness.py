"""MCQA evaluation pipeline (counterpart of ``distllm_tpu.mcqa.harness``):
load the config and the questions, boot a local engine server when
``local_model_path`` is set, resume from checkpoints, answer the questions
in a thread pool through client-side batching (``ApiGenerator`` ->
``BatchingClient`` -> HTTP -> the engine), grade each answer with a second
LLM (the JSON retry ladder), compute accuracy and retrieval metrics, and
write ``results.json``, ``incorrect_answers.json`` and an audit copy of
the config (as JSON, which either package's ``from_yaml`` reads).

    python -m distllm_tpu_torch.mcqa.harness --config mcqa.yaml [--device cpu]

``--device`` places the retriever's query encoder and index and is passed
to a booted server; without it both run on CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Any

from distllm_tpu_torch.mcqa.batching import BatchingClient
from distllm_tpu_torch.mcqa.checkpoint import CheckpointManager
from distllm_tpu_torch.mcqa.config import MCQAConfig
from distllm_tpu_torch.mcqa.grading import grade_answer
from distllm_tpu_torch.observability.flight import StallWatchdog
from distllm_tpu_torch.observability.instruments import log_event


# --------------------------------------------------------------- chunk ids
def chunk_id(path: str, index: int) -> str:
    """Stable chunk identifier ``sha256(path)[:16]_{idx:04d}``."""
    digest = hashlib.sha256(str(path).encode()).hexdigest()[:16]
    return f'{digest}_{index:04d}'


def question_hash(question: str) -> str:
    return hashlib.sha256(question.strip().encode()).hexdigest()[:16]


# ------------------------------------------------------------- progress bar
class _PlainProgress:
    """The progress line when tqdm is absent."""

    def __init__(self, total: int) -> None:
        self.total = total
        self.count = 0  # guarded by self._lock
        self._lock = threading.Lock()

    def update(self, n: int = 1) -> None:
        with self._lock:
            self.count += n
            if self.count % max(1, self.total // 20) == 0 or self.count == self.total:
                log_event(f'[mcqa] {self.count}/{self.total}', component='mcqa')

    def close(self) -> None:
        pass


def _progress(total: int):
    try:
        from tqdm import tqdm

        return tqdm(total=total, desc='mcqa')
    except ImportError:
        return _PlainProgress(total)


# ----------------------------------------------------------------- loading
def load_questions(path: str | Path) -> list[dict[str, Any]]:
    """Argonium-style questions: JSON list (or jsonl) of
    ``{question, answer, ...}`` entries."""
    path = Path(path)
    text = path.read_text()
    if path.suffix == '.jsonl':
        entries = [json.loads(line) for line in text.splitlines() if line.strip()]
    else:
        entries = json.loads(text)
    for entry in entries:
        if 'question' not in entry or 'answer' not in entry:
            raise ValueError(
                'each question entry needs "question" and "answer" fields'
            )
    return entries


# -------------------------------------------------------------- generation
class RagAnswerer:
    """Answer generation with the retrieved chunks logged; the retriever
    (the port's ``rag.search``, built from ``retriever_config`` as the JAX
    harness builds it) runs on ``device`` (``None`` = CUDA)."""

    def __init__(
        self, config: MCQAConfig, client: BatchingClient, device: 'str | None' = None
    ) -> None:
        self.config = config
        self.client = client
        self.retriever = None
        if config.retriever_config is not None:
            from distllm_tpu_torch.rag.search import RetrieverConfig

            self.retriever = RetrieverConfig.from_dict(
                config.retriever_config
            ).get_retriever(register=True, device=device)

    def answer(self, question: str) -> dict[str, Any]:
        retrieval_log: list[dict[str, Any]] = []
        prompt = question
        if self.retriever is not None:
            results, _ = self.retriever.search(
                question,
                top_k=self.config.retrieval_top_k,
                score_threshold=self.config.retrieval_score_threshold,
            )
            indices = results.total_indices[0]
            scores = results.total_scores[0]
            texts = self.retriever.get_texts(indices) if indices else []
            def column(key: str) -> list:
                try:
                    return self.retriever.get(indices, key) if indices else []
                except KeyError:
                    return ['' for _ in indices]

            paths = column('path')
            # Chunks produced by question-generation pipelines may carry the
            # hash of the question they were generated from.
            qhashes = column('question_hash')
            for rank, (idx, score, text, path, qhash) in enumerate(
                zip(indices, scores, texts, paths, qhashes)
            ):
                entry = {
                    'rank': rank,
                    'dataset_index': idx,
                    'score': score,
                    'chunk_id': chunk_id(path, idx),
                    'path': path,
                    'text_preview': text[:200],
                }
                if qhash:
                    entry['question_hash'] = qhash
                retrieval_log.append(entry)
            context = '\n\n'.join(texts)
            prompt = (
                f'Context:\n{context}\n\nQuestion: {question}\n'
                'Answer the question by choosing one of the options. '
                'Output only your chosen option.\nAnswer: '
            )

        # No outer retry: the transport (ApiGenerator._chat) already does
        # exponential backoff; a second layer here would multiply attempts.
        # prefix_hint: per-choice prompts of one question share the same
        # retrieval context + stem — batching them adjacently lets a
        # prefix-caching server prefill the stem once.
        response = self.client.generate(
            prompt, timeout=600, prefix_hint=question_hash(question)
        )
        return {'answer': response, 'retrieval': retrieval_log, 'prompt': prompt}


# ----------------------------------------------------------------- metrics
def retrieval_metrics(results: dict[int, dict[str, Any]]) -> dict[str, float]:
    """Source-chunk-retrieved and question-hash-retrieved rates: among
    questions that carry source ``chunk_id`` / ``question_hash`` metadata,
    how often retrieval surfaced them."""
    chunk_hits = chunk_total = 0
    hash_hits = hash_total = 0
    # Hash matching is meaningful only when the *corpus* carries
    # question-hash metadata (chunks from question-generation pipelines)
    # — decided globally, so a question whose retrieval came
    # back empty still counts as a miss rather than dropping out of the
    # denominator (which would inflate the rate). A total retrieval miss
    # would hide the hash evidence, so hash-annotated *questions* also mark
    # the metric applicable — then a zero-retrieval run reports 0.0 instead
    # of silently omitting the metric.
    hashes_in_corpus = any(
        'question_hash' in r
        for result in results.values()
        for r in result.get('retrieval', [])
    ) or any(
        'question_hash' in result.get('entry', {})
        for result in results.values()
    )
    for result in results.values():
        question = result.get('entry', {})
        retrieved = result.get('retrieval', [])
        source = question.get('chunk_id')
        if source:
            chunk_total += 1
            chunk_hits += any(r['chunk_id'] == source for r in retrieved)
        if hashes_in_corpus:
            qhash = question.get('question_hash') or question_hash(
                question.get('question', '')
            )
            hash_total += 1
            hash_hits += any(
                r.get('question_hash') == qhash for r in retrieved
            )
    metrics = {}
    if chunk_total:
        metrics['source_chunk_retrieved_rate'] = chunk_hits / chunk_total
    if hash_total:
        metrics['question_hash_retrieved_rate'] = hash_hits / hash_total
    return metrics


# -------------------------------------------------------------------- main
def run_mcqa(config: MCQAConfig, device: 'str | None' = None) -> dict[str, Any]:
    """The evaluation; returns the summary written to ``results.json``.
    ``device`` (``None`` = CUDA) places the retriever and is passed to a
    booted server."""
    config.output_dir.mkdir(parents=True, exist_ok=True)
    # Audit copy, written as JSON: JSON is valid YAML.
    (config.output_dir / 'config.yaml').write_text(
        json.dumps(config.to_dict(), indent=2) + '\n'
    )
    questions = load_questions(config.questions_file)

    # Optional local engine-server boot.
    server = None
    model_base, model_key, model_name = config.resolve_model_endpoint()
    if config.local_model_path:
        from distllm_tpu_torch.mcqa.server_boot import LocalServerManager

        server = LocalServerManager(
            config.local_model_path,
            log_dir=config.output_dir / 'server_logs',
            engine_args={
                'max_model_len': config.vllm_args.max_model_len,
                'max_num_seqs': config.vllm_args.max_num_seqs,
                'block_size': config.vllm_args.block_size,
                'num_blocks': config.vllm_args.num_blocks,
                'tensor_parallel_size': config.vllm_args.tensor_parallel_size,
            },
            device=device,
        )
        server.start()
        model_base, model_key = server.base_url, ''

    from distllm_tpu_torch.generate.generators.api_backend import (
        ApiGenerator,
        ApiGeneratorConfig,
    )

    model_client = ApiGenerator(
        ApiGeneratorConfig(
            provider='openai',
            openai_api_base=model_base,
            model=model_name,
            api_key=model_key,
            temperature=config.request_temperature,
            max_tokens=config.request_max_tokens,
        )
    )
    batcher = BatchingClient(
        model_client.generate,
        batch_size=config.batch_size,
        batch_timeout=config.batch_timeout,
    )
    try:
        answerer = RagAnswerer(config, batcher, device=device)
    except BaseException:
        batcher.close()
        if server is not None:
            server.stop()
        raise

    grader_base, grader_key, grader_model = config.resolve_grader_endpoint()
    grader_client = ApiGenerator(
        ApiGeneratorConfig(
            provider='openai',
            openai_api_base=grader_base,
            model=grader_model,
            api_key=grader_key,
            temperature=config.grader_temperature,
            max_tokens=config.grader_max_new_tokens,
        )
    )

    checkpoints = CheckpointManager(
        config.output_dir / 'checkpoints',
        metadata={
            'model': model_name,
            'questions_file': str(config.questions_file),
        },
        every=config.checkpoint_every,
        save_incremental=config.save_incremental,
    )
    if config.resume:
        checkpoints.try_resume()
    todo = [
        i for i in range(len(questions))
        if i not in checkpoints.completed_indices
    ]
    log_event(
        f'[mcqa] {len(todo)}/{len(questions)} questions to process',
        component='mcqa',
    )

    progress = _progress(len(todo))
    start_time = time.perf_counter()

    def process_question(index: int) -> None:
        entry = questions[index]
        generated = answerer.answer(entry['question'])
        verdict = grade_answer(
            lambda p: grader_client.generate([p])[0],
            question=entry['question'],
            reference=entry['answer'],
            answer=generated['answer'],
        )
        checkpoints.record(
            index,
            {
                'entry': entry,
                'answer': generated['answer'],
                'retrieval': generated['retrieval'],
                'correct': verdict['correct'],
                'grader_reason': verdict.get('reason', ''),
                'grader_ladder_level': verdict.get('ladder_level', 0),
            },
        )
        progress.update(1)

    errors: list[tuple[int, str]] = []
    # Stall watchdog over question completions: a wedged model server or a
    # deadlocked batcher shows up as zero progress, and the dumped bundle
    # (flight ring + metrics + traces in output_dir/debug_bundle) explains
    # the wedge even if the run is later killed. DISTLLM_MCQA_WATCHDOG_S=0
    # disables; the dog never kills the run itself.
    watchdog_s = float(os.environ.get('DISTLLM_MCQA_WATCHDOG_S', '900') or 0)
    watchdog = None
    if todo and watchdog_s > 0:
        watchdog = StallWatchdog(
            watchdog_s,
            progress_fn=lambda: len(checkpoints.completed_indices),
            bundle_dir=config.output_dir / 'debug_bundle',
            name='mcqa',
        ).start()
    try:
        with ThreadPoolExecutor(max_workers=config.parallel_workers) as pool:
            futures = {pool.submit(process_question, i): i for i in todo}
            for future in as_completed(futures):
                index = futures[future]
                try:
                    future.result()
                except Exception as exc:  # noqa: BLE001 - recorded + reported
                    errors.append((index, repr(exc)))
    finally:
        if watchdog is not None:
            watchdog.stop()
        progress.close()
        batcher.close()
        if server is not None:
            server.stop()
        checkpoints.save()

    elapsed = time.perf_counter() - start_time
    results = checkpoints.results
    graded = [r for r in results.values() if 'correct' in r]
    correct = sum(bool(r['correct']) for r in graded)
    summary: dict[str, Any] = {
        'total_questions': len(questions),
        'graded': len(graded),
        'correct': correct,
        'accuracy': correct / len(graded) if graded else 0.0,
        'errors': errors,
        'elapsed_s': elapsed,
        'throughput_qps': len(todo) / elapsed if elapsed > 0 else 0.0,
        'batches_sent': batcher.batches_sent,
        **retrieval_metrics(results),
        'model': model_name,
        'questions_file': str(config.questions_file),
    }
    (config.output_dir / 'results.json').write_text(
        json.dumps(
            {'summary': summary, 'results': {str(k): v for k, v in results.items()}},
            indent=2,
        )
    )
    # Incorrect-answer export.
    incorrect = [
        {'index': k, **v} for k, v in results.items() if not v.get('correct', True)
    ]
    (config.output_dir / 'incorrect_answers.json').write_text(
        json.dumps(incorrect, indent=2)
    )
    log_event(
        f'[mcqa] accuracy={summary["accuracy"]:.3f} ({correct}/{len(graded)})',
        component='mcqa',
    )
    return summary


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--config', required=True, type=Path)
    parser.add_argument(
        '--device', default=None,
        help="device of the retriever and a booted server (default: cuda; 'cpu' only "
        'when asked)',
    )
    args = parser.parse_args(argv)
    run_mcqa(MCQAConfig.from_yaml(args.config), device=args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())

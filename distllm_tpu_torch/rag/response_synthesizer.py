"""RAG response synthesis: retrieve -> prompt -> generate -> postprocess
(the PyTorch counterpart of ``distllm_tpu.rag.response_synthesizer``).
With no retriever the generator runs as the no-RAG baseline; with one,
each query's top-k texts and scores go into the prompt template."""

from __future__ import annotations

from distllm_tpu_torch.generate.prompts import get_prompt_template
from distllm_tpu_torch.generate.prompts.base import PromptTemplate


class RagGenerator:
    """Generate responses to queries with optional retrieval augmentation."""

    def __init__(self, generator, retriever=None) -> None:
        self.generator = generator
        self.retriever = retriever

    def generate(
        self,
        texts: str | list[str],
        prompt_template: PromptTemplate | None = None,
        retrieval_top_k: int = 5,
        retrieval_score_threshold: float = 0.0,
    ) -> list[str]:
        if isinstance(texts, str):
            texts = [texts]
        if prompt_template is None:
            prompt_template = get_prompt_template({'name': 'identity'})

        contexts, scores = None, None
        if self.retriever is not None:
            results, _ = self.retriever.search(
                texts, top_k=retrieval_top_k, score_threshold=retrieval_score_threshold
            )
            contexts = [
                self.retriever.get_texts(indices) for indices in results.total_indices
            ]
            scores = results.total_scores

        prompts = prompt_template.preprocess(texts, contexts, scores)
        responses = prompt_template.postprocess(self.generator.generate(prompts))
        if len(texts) != len(responses):
            raise RuntimeError(
                f'{len(texts)} queries but {len(responses)} responses'
            )
        return responses

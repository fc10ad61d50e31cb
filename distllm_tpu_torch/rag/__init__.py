"""RAG: the retrieval index and ``Retriever``, response synthesis, and the
QA evaluation tasks (the PyTorch counterpart of ``distllm_tpu.rag``)."""

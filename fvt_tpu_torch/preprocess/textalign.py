"""Text pipeline: BERT token embeddings + token->frame alignment; the port
of ``fvt_tpu/preprocess/textalign.py``.

The upstream's base/speech.py:185-251 (BERT sum-of-last-4-layers per
token, CLS/SEP/pad dropped) and :690-738 (``align_word_embedding_new``:
frames partitioned into n_token contiguous blocks, extra tokens
truncated), ``fvt_tpu``'s code but that :func:`extract_word_embedding`
puts its inputs on the model's device.

Transcription (Vosk) and punctuation restoration are external-model
steps; they are pluggable here (any callable str->words) and gated on
their packages being installed.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from fvt_tpu_torch.preprocess.sharding import divide

BERT_DIM = 768


_WARNED_NLTK_FALLBACK = False


def split_sentences(paragraph: str) -> List[str]:
    """NLTK sentence split when available, regex fallback otherwise.

    The splitter choice is NUMERICS-DEFINING for bert.npy (different
    sentence boundaries -> different per-sentence BERT contexts ->
    different embedding rows), so falling back logs a loud one-time
    warning — mixing shards from nltk and non-nltk environments inside
    one store would otherwise be silent (the extractor generation stamp
    cannot see library availability)."""
    try:
        from nltk import tokenize as tk
        return tk.sent_tokenize(paragraph)
    except (ImportError, LookupError):
        global _WARNED_NLTK_FALLBACK
        if not _WARNED_NLTK_FALLBACK:
            _WARNED_NLTK_FALLBACK = True
            from fvt_tpu_torch.utils.logger import log
            log("WARNING: nltk (punkt) unavailable — using the regex "
                "sentence splitter. bert.npy rows from this run will "
                "differ from an nltk-equipped run; do not mix such "
                "shards in one store.")
        parts = re.split(r'(?<=[.!?])\s+', paragraph.strip())
        return [p for p in parts if p]


def extract_word_embedding(transcript: str, tokenizer, model,
                           max_length: int = 256) -> np.ndarray:
    """(n_tokens, 768): sum of the last 4 hidden layers per real token.

    CLS/SEP and padding are dropped (speech.py:185-251).  ``model`` must
    output hidden states (HF BertModel(output_hidden_states=True)).
    """
    import torch

    device = next(model.parameters()).device
    sentences = split_sentences(transcript)
    if not sentences:
        return np.zeros((0, BERT_DIM), dtype=np.float32)

    all_feats = []
    for sentence in sentences:
        enc = tokenizer.encode_plus(
            sentence, add_special_tokens=True, max_length=max_length,
            padding='max_length', truncation=True,
            return_attention_mask=True, return_tensors='pt')
        with torch.no_grad():
            out = model(enc['input_ids'].to(device), token_type_ids=None,
                        attention_mask=enc['attention_mask'].to(device))
        hidden = torch.stack(out.hidden_states)  # (L+1, 1, T, 768)
        hidden = hidden.permute(1, 2, 0, 3)[0]   # (T, L+1, 768)
        summed = hidden[:, -4:, :].sum(dim=1).cpu().numpy()  # (T, 768)

        mask = enc['attention_mask'][0].numpy().astype(bool)
        if mask.all():
            # the upstream refuses a sentence that fills max_length
            # (speech.py:573-575) rather than silently truncating —
            # truncation would change bert.npy's token count/content
            raise ValueError('The sentence is too long, enlarge the '
                             'token number!')
        ids = enc['input_ids'][0].numpy()
        real = mask.copy()
        # drop special tokens (CLS=101, SEP=102 for bert-base-uncased)
        real &= (ids != tokenizer.cls_token_id)
        real &= (ids != tokenizer.sep_token_id)
        all_feats.append(summed[real])

    return np.vstack(all_feats).astype(np.float32)


def align_word_embedding_new(word_embeddings: np.ndarray,
                             annotated_idx: np.ndarray) -> np.ndarray:
    """(n_frames, 768): frames split into n_token contiguous blocks, each
    block assigned its token's embedding; extra tokens truncated
    (speech.py:690-738)."""
    idxs = annotated_idx.tolist()
    z = len(idxs)
    assert z > 0
    aligned = np.zeros((z, BERT_DIM), dtype=np.float32)

    n = word_embeddings.shape[0]
    if n == 0:
        return aligned
    if n > z:
        word_embeddings = word_embeddings[:z]
        n = z

    blocks = divide(n, idxs)
    pos = {}
    for j, block in enumerate(blocks):
        for i in block:
            # FIRST block containing a duplicated index wins — the
            # upstream scans blocks in order and breaks on the first
            # hit (speech.py:724-731)
            pos.setdefault(i, j)
    for k, i in enumerate(idxs):
        aligned[i] = word_embeddings[pos[i]]
    return aligned


def transcribe(wav_path: str, model_dir: Optional[str] = None) -> dict:
    """Vosk speech-to-text with word timestamps (speech.py:63-96); gated
    on the vosk package + a local model directory.

    Returns {'text': str, 'words': [{'word', 'start', 'end', 'conf'}]}.
    """
    try:
        import vosk  # noqa: F401
    except ImportError as e:
        raise NotImplementedError(
            'transcription needs the vosk package (not in this image); '
            'fold-file transcripts are consumed directly instead') from e
    import json
    import wave

    model = _vosk_model(model_dir)
    with wave.open(wav_path, 'rb') as wf:
        rec = vosk.KaldiRecognizer(model, wf.getframerate())
        rec.SetWords(True)
        words, texts = [], []
        while True:
            data = wf.readframes(4000)
            if len(data) == 0:
                break
            if rec.AcceptWaveform(data):
                res = json.loads(rec.Result())
                texts.append(res.get('text', ''))
                words.extend(res.get('result', []))
        res = json.loads(rec.FinalResult())
    texts.append(res.get('text', ''))
    words.extend(res.get('result', []))
    return {'text': ' '.join(t for t in texts if t), 'words': words}


# per-model-dir caches: vosk models are 50 MB-1.8 GB and the punctuation
# restorer is a full transformer — reloading either once per TRIAL
# dominated driver wall time on this 1-core host
_VOSK_MODELS: dict = {}
_PUNCT_MODEL = None


def _vosk_model(model_dir: Optional[str]):
    import vosk
    if model_dir not in _VOSK_MODELS:
        _VOSK_MODELS[model_dir] = (vosk.Model(model_dir) if model_dir
                                   else vosk.Model(lang='en-us'))
    return _VOSK_MODELS[model_dir]


def make_vosk_transcriber(model_dir: Optional[str] = None):
    """wav_path -> transcript text, the driver-chain transcriber contract
    (any callable with this signature can be injected instead)."""
    def _transcribe(wav_path: str) -> str:
        return transcribe(wav_path, model_dir)['text']
    return _transcribe


def add_punctuation(text: str) -> str:
    """Punctuation restoration (speech.py:99-182); gated on the
    deepmultilingualpunctuation package, identity fallback otherwise."""
    try:
        from deepmultilingualpunctuation import PunctuationModel
    except ImportError:
        return text
    global _PUNCT_MODEL
    if _PUNCT_MODEL is None:
        _PUNCT_MODEL = PunctuationModel()
    return _PUNCT_MODEL.restore_punctuation(text)


def load_bert(model_name: str = 'bert-base-uncased'):
    """HF tokenizer+model pair for embedding extraction (gated on weights
    being available locally or downloadable)."""
    from transformers import BertTokenizer, BertModel
    tokenizer = BertTokenizer.from_pretrained(model_name)
    model = BertModel.from_pretrained(model_name,
                                      output_hidden_states=True)
    model.eval()
    return tokenizer, model

"""Bucketed sentence iterator for RNN language modeling, on the
PyTorch/CUDA port (``mxnet_tpu_torch``).

The copy of ``example/rnn/bucket_io.py`` (parity: the reference's
BucketSentenceIter :114, default_gen_buckets :43) that differs only in
the import lines and in building its batches as CPU NDArrays, as the
port's iterators do (the executor group copies them to its device).
Sentences are grouped by length into buckets; each batch is drawn from
one bucket and padded to that bucket's length, so the BucketingModule
binds one executor per bucket.
"""
import bisect

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io import DataBatch, DataIter


def default_gen_buckets(sentences, batch_size, the_vocab):
    """Pick bucket lengths covering the corpus (parity bucket_io.py:43)."""
    len_dict = {}
    max_len = -1
    for sentence in sentences:
        words = default_text2id(sentence, the_vocab)
        if len(words) == 0:
            continue
        max_len = max(max_len, len(words))
        len_dict[len(words)] = len_dict.get(len(words), 0) + 1

    tl = 0
    buckets = []
    for l, n in sorted(len_dict.items()):
        if n + tl >= batch_size:
            buckets.append(l)
            tl = 0
        else:
            tl += n
    if tl > 0 and buckets and buckets[-1] != max_len:
        buckets.append(max_len)
    return buckets


def default_build_vocab(path):
    """word -> id map; 0 reserved for padding (parity bucket_io.py:19)."""
    content = open(path).read()
    content = content.replace("\n", " <eos> ").split()
    idx = 1  # 0 is padding
    vocab = {}
    for word in content:
        if word not in vocab:
            vocab[word] = idx
            idx += 1
    return vocab


def default_text2id(sentence, the_vocab):
    words = sentence.split()
    return [the_vocab[w] for w in words if w]


def synthetic_corpus(num_sentences=600, vocab_size=120, seed=3,
                     lengths=(8, 16, 24, 32)):
    """Markov-ish synthetic sentences for hermetic runs."""
    rng = np.random.RandomState(seed)
    sents = []
    for _ in range(num_sentences):
        n = int(rng.choice(lengths)) - int(rng.randint(0, 4))
        tok = rng.randint(1, vocab_size)
        out = []
        for _ in range(max(n, 2)):
            out.append(tok)
            tok = (tok * 31 + int(rng.randint(0, 7))) % (vocab_size - 1) + 1
        sents.append(out)
    return sents


class BucketSentenceIter(DataIter):
    """Parity: bucket_io.py:114.  ``sentences`` is a list of id-lists (or
    raw text path + vocab via the helpers above)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 init_states=None, data_name="data",
                 label_name="softmax_label", seed=1):
        super().__init__()
        if buckets is None:
            lens = sorted({len(s) for s in sentences})
            buckets = lens if len(lens) <= 8 else \
                [lens[i * len(lens) // 8] for i in range(1, 8)] + [lens[-1]]
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.init_states = init_states or []
        self.init_state_arrays = [np.zeros(shape, np.float32)
                                  for _, shape in self.init_states]
        self._rng = np.random.RandomState(seed)

        self.data = [[] for _ in self.buckets]
        ndiscard = 0
        for sentence in sentences:
            if len(sentence) == 0:
                continue
            buck = bisect.bisect_left(self.buckets, len(sentence))
            if buck == len(self.buckets):
                ndiscard += 1
                continue
            buff = np.zeros((self.buckets[buck],), np.float32)
            buff[:len(sentence)] = sentence
            self.data[buck].append(buff)
        self.data = [np.asarray(x) if x else
                     np.zeros((0, b), np.float32)
                     for x, b in zip(self.data, self.buckets)]
        if ndiscard:
            print("WARNING: discarded %d sentences longer than the largest "
                  "bucket" % ndiscard)

        self.default_bucket_key = max(self.buckets)
        self.reset()

    @property
    def provide_data(self):
        return ([(self.data_name, (self.batch_size,
                                   self.default_bucket_key))]
                + list(self.init_states))

    @property
    def provide_label(self):
        return [(self.label_name, (self.batch_size,
                                   self.default_bucket_key))]

    def reset(self):
        self._plan = []
        for i, d in enumerate(self.data):
            idx = self._rng.permutation(len(d))
            for k in range(0, len(idx) - self.batch_size + 1,
                           self.batch_size):
                self._plan.append((i, idx[k:k + self.batch_size]))
        self._rng.shuffle(self._plan)
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        bucket, rows = self._plan[self._cursor]
        self._cursor += 1
        seq_len = self.buckets[bucket]
        x = self.data[bucket][rows]
        label = np.zeros_like(x)
        label[:, :-1] = x[:, 1:]
        cpu = mx.cpu()
        data_all = ([mx.nd.array(x, ctx=cpu)]
                    + [mx.nd.array(a, ctx=cpu)
                       for a in self.init_state_arrays])
        batch = DataBatch(data=data_all, label=[mx.nd.array(label, ctx=cpu)],
                          pad=0, index=None, bucket_key=seq_len,
                          provide_data=(
                              [(self.data_name, (self.batch_size, seq_len))]
                              + list(self.init_states)),
                          provide_label=[(self.label_name,
                                          (self.batch_size, seq_len))])
        return batch

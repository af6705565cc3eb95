"""Evaluation metrics.

A copy of ``mxnet_tpu/metric.py`` (framework-free: metric math runs in
numpy on the host, after the outputs' ``asnumpy``): EvalMetric with
update(labels, preds)/reset/get, CompositeEvalMetric, Accuracy,
TopKAccuracy, F1, Perplexity, MAE, MSE, RMSE, CrossEntropy, Loss, Torch,
Caffe, CustomMetric, ``np()`` and the ``create()`` factory.
"""
from __future__ import annotations

import numpy


__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "Loss", "Torch", "CustomMetric", "np", "create"]


def check_label_shapes(labels, preds, shape=0):
    """Parity: metric.py check_label_shapes."""
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))


def _asnumpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return numpy.asarray(x)


class EvalMetric(object):
    """Base metric (parity: metric.py:22)."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [x / y if y != 0 else float("nan")
                  for x, y in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """A bundle of child metrics driven through one EvalMetric interface
    (role: metric.py CompositeEvalMetric)."""

    def __init__(self, **kwargs):
        super().__init__("composite")
        self.metrics = kwargs.get("metrics", [])

    def add(self, metric):
        self.metrics.append(metric)

    def get_metric(self, index):
        if not 0 <= index < len(self.metrics):
            raise ValueError("no child metric at index %d (have %d)"
                             % (index, len(self.metrics)))
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        # base __init__ calls reset() before self.metrics exists
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        pairs = [metric.get() for metric in self.metrics]
        return ([name for name, _ in pairs], [value for _, value in pairs])


class Accuracy(EvalMetric):
    """Classification accuracy (parity: metric.py Accuracy): argmax over the
    last axis when pred has an extra class dim, else direct compare."""

    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label = _asnumpy(pred_label)
            label = _asnumpy(label)
            if pred_label.shape != label.shape:
                pred_label = numpy.argmax(pred_label, axis=1)
            pred_label = pred_label.astype("int32").flatten()
            label = label.astype("int32").flatten()
            check_label_shapes(label, pred_label, shape=1)
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


class TopKAccuracy(EvalMetric):
    """Top-k accuracy (parity: metric.py TopKAccuracy)."""

    def __init__(self, **kwargs):
        super().__init__("top_k_accuracy")
        self.top_k = kwargs.get("top_k", 1)
        assert self.top_k > 1, "top_k must exceed 1 (use Accuracy for top-1)"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label = _asnumpy(pred_label)
            label = _asnumpy(label)
            assert len(pred_label.shape) <= 2, "Predictions should be no more than 2 dims"
            label = label.astype("int32").ravel()
            if pred_label.ndim == 1:
                self.sum_metric += int((pred_label == label).sum())
            else:
                k = min(self.top_k, pred_label.shape[1])
                # membership of the true class among the k best scores
                ranked = numpy.argsort(pred_label.astype("float32"), axis=1)
                topk = ranked[:, -k:]
                self.sum_metric += int(
                    (topk == label[:, None]).any(axis=1).sum())
            self.num_inst += label.shape[0]


class F1(EvalMetric):
    """Binary F1 (parity: metric.py F1)."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _asnumpy(pred)
            label = _asnumpy(label).astype("int32").ravel()
            if numpy.unique(label).size > 2:
                raise ValueError("F1 is defined here for binary labels only")
            hat = numpy.argmax(pred, axis=1)
            tp = float(numpy.sum((hat == 1) & (label == 1)))
            fp = float(numpy.sum((hat == 1) & (label == 0)))
            fn = float(numpy.sum((hat == 0) & (label == 1)))
            precision = tp / (tp + fp) if tp + fp else 0.0
            recall = tp / (tp + fn) if tp + fn else 0.0
            score = (2.0 * precision * recall / (precision + recall)
                     if precision + recall else 0.0)
            self.sum_metric += score
            self.num_inst += 1


class Perplexity(EvalMetric):
    """Perplexity over softmax outputs (parity: metric.py Perplexity);
    ``ignore_label`` masks padding (used by lstm_bucketing)."""

    def __init__(self, ignore_label=None, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.
        num = 0
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            assert label.size == pred.size / pred.shape[self.axis], \
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            label = label.reshape((label.size,))
            pred = pred.reshape((-1, pred.shape[self.axis]))
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(pred.dtype)
                prob = prob * (1 - ignore) + ignore
                num -= numpy.sum(ignore)
            loss += -numpy.sum(numpy.log(numpy.maximum(1e-10, prob)))
            num += label.shape[0]
        self.sum_metric += numpy.exp(loss / num) * num
        self.num_inst += num


class MAE(EvalMetric):
    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


class MSE(EvalMetric):
    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


class RMSE(EvalMetric):
    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


class CrossEntropy(EvalMetric):
    """Cross-entropy of softmax outputs vs integer labels (parity:
    metric.py CrossEntropy)."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


class Loss(EvalMetric):
    """Mean of raw loss outputs (for MakeLoss heads; beyond-reference helper)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            pred = _asnumpy(pred)
            self.sum_metric += pred.sum()
            self.num_inst += pred.size


class Torch(Loss):
    """Parity stub for reference Torch criterions metric (mean of outputs)."""

    def __init__(self):
        EvalMetric.__init__(self, "torch")


class Caffe(Torch):
    """Dummy metric for caffe criterions (reference metric.py Caffe)."""

    def __init__(self):
        EvalMetric.__init__(self, "caffe")


class CustomMetric(EvalMetric):
    """Metric from a feval function (parity: metric.py CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval as a metric (parity: metric.py np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, **kwargs):
    """Factory (parity: metric.py create)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    metrics = {
        "acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
        "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
        "top_k_accuracy": TopKAccuracy, "perplexity": Perplexity,
        "loss": Loss, "torch": Torch, "caffe": Caffe,
    }
    try:
        return metrics[metric.lower()](**kwargs)
    except Exception:
        raise ValueError("Metric must be either callable object or in registry")

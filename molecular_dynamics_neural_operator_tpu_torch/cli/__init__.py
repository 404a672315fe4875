"""The port's command-line entry points: ``train``, ``rollout``,
``serve``, ``export`` and ``preprocess``, each with the JAX package's
flags."""

"""Training of the port's dense predictors: AdamW (``optimizer``), int8
gradient compression (``grad_compress``), the train step
(``train_loop``), checkpoints (``checkpoint``) and the recipe that makes
the CLI's trained ``pred-*`` predictors (``prep``)."""

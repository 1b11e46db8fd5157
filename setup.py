from setuptools import find_packages, setup

setup(
    name="pasero-tpu",
    version="0.1.0",
    description="TPU-native text generation framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["pasero_tpu*", "pasero_torch*", "cli*"]),
    package_data={"pasero_tpu.serving": ["static/*.html"]},
    python_requires=">=3.10",
    entry_points={
        "console_scripts": [
            "pasero-train=cli.train:main",
            "pasero-decode=cli.decode:main",
            "pasero-serve=cli.serve:main",
            "pasero-serve-hf=cli.serve_hf:main",
            "pasero-retriever=cli.retriever:main",
            "pasero-tokenize=cli.tokenizer_cli:tokenize_main",
            "pasero-detokenize=cli.tokenizer_cli:detokenize_main",
            "pasero-build-tokenizer=cli.tokenizer_cli:build_tokenizer_main",
            "pasero-build-dict=cli.tokenizer_cli:build_dict_main",
        ]
    },
)

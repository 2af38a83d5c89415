"""Packaging for basicsr4rs_tpu (reference packaging: setup.py in the
upstream repo; this framework is pure Python on top of jax/flax/optax)."""

import os.path as osp

from setuptools import find_packages, setup


def readme():
    with open(osp.join(osp.dirname(__file__), 'README.md'), encoding='utf-8') as f:
        return f.read()


setup(
    name='basicsr4rs_tpu',
    version='0.1.0',
    description='TPU-native image and video restoration framework '
                '(super-resolution, denoising, GAN/diffusion restoration, '
                'remote-sensing Landsat-to-Sentinel workflows)',
    long_description=readme(),
    long_description_content_type='text/markdown',
    author='basicsr4rs-tpu contributors',
    keywords='computer vision, super resolution, jax, tpu, restoration',
    packages=find_packages(exclude=('options', 'datasets', 'experiments',
                                    'results', 'tests', 'scripts', 'inference')),
    package_data={'basicsr4rs_tpu': ['metrics/niqe_pris_params.npz'],
                  'basicsr4rs_torch': ['csrc/*.cu', 'csrc/*.cuh',
                                       'metrics/niqe_pris_params.npz']},
    classifiers=[
        'Development Status :: 4 - Beta',
        'License :: OSI Approved :: Apache Software License',
        'Operating System :: OS Independent',
        'Programming Language :: Python :: 3',
    ],
    license='Apache License 2.0',
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy', 'opencv-python',
        'pyyaml', 'scipy',
    ],
    extras_require={
        'data': ['lmdb', 'rasterio', 'tacoreader'],
        'torch-convert': ['torch'],
    },
    entry_points={
        'console_scripts': [
            'basicsr4rs-train = basicsr4rs_tpu.train:main',
            'basicsr4rs-test = basicsr4rs_tpu.test:main',
        ],
    },
)
